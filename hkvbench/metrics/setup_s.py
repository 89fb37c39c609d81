"""Process start to the first timed batch, in s: imports, the kernel
library's build or load, the table, its prefill and the warm-up batches."""


def read(run):
    return run.setup_s

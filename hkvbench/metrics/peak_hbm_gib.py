"""`torch.cuda.max_memory_allocated()` from before set-up to the window's
end, in GiB (a value plane in pinned host memory is not device memory)."""


def read(run):
    return run.peak_bytes / 2**30

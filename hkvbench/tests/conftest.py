"""Test-session set-up: under pytest-xdist, each worker process takes an
equal share of the cores for torch's intra-op threads.

By default every worker starts torch with one intra-op thread a core, so
n workers run n threads a core and torch's small CPU ops mostly wait for
one another.  Outside xdist nothing is set."""

import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    try:
        import torch
    except ImportError:
        return
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    torch.set_num_threads(max(1, (cores or 1) // int(workers)))

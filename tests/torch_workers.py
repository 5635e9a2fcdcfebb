"""Share the machine's cores among pytest-xdist workers.

PyTorch starts one intra-op thread per core in every process.  Under
``pytest -n N`` each of the N workers does so, and N x cores spinning
OpenMP threads on the same cores slow a CPU-bound test by one to two
orders of magnitude (a tiny text fit: ~1 s alone, ~210 s beside five
busy workers).  The port's test modules import this one: in a worker it
gives torch ``cores // N`` threads (at least one); run without xdist it
changes nothing.  Tests that set their own thread count (the strided
convolution tests) still do.
"""

import os

import torch


def share_cores() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


THREADS = share_cores()

"""Cap torch's intra-op threads to this process's share of the cores.

Under pytest-xdist every worker is a process of its own, and torch gives
each one a thread per core, so ``-n 6`` on 8 cores runs 48 threads on 8
cores.  Each port test file imports this module, which gives a worker
cores // workers threads; outside xdist it changes nothing.
"""

import os

import torch

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    torch.set_num_threads(
        max(1, len(os.sched_getaffinity(0)) // int(_workers)))

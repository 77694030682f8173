"""Caps torch's intra-op threads in the port's CPU tests.

Under pytest-xdist every worker is a process of its own, and torch gives
each one as many intra-op threads as the host has cores: six workers on
an eight-core host then run 48 threads and time-slice each other's
products. Imported first by every ``tests/test_torch_*.py``, this module
gives a worker its share of the cores instead, unless ``OMP_NUM_THREADS``
already sets the count. Not a test module.
"""

import os

import torch

if "OMP_NUM_THREADS" not in os.environ:
    _workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))

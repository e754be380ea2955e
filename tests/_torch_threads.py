"""Imported first by every ``tests/test_torch_*.py``: under pytest-xdist
each worker runs torch with ONE intra-op thread.

Left alone, every worker's torch starts one thread per CPU, so six
workers on an eight-CPU machine run ~48 busy threads and a SHARP session
that takes seconds alone takes minutes beside its neighbours.  Results
do not change: every comparison in these files is between two runs in
one process, or against a tolerance.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

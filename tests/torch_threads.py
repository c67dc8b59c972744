"""Caps torch's CPU thread pools at one thread in a test process.

Every ``tests/test_torch_*.py`` imports this module before any torch work.
The tier-1 run puts six pytest-xdist workers on one machine; left alone,
each worker's torch would start one intra-op thread per core, and six
workers would oversubscribe the cores several times over. One thread per
worker measured faster than two on the slowest port files. torch lets the
inter-op pool be sized only before its first parallel work, so that cap is
made where it still can be.
"""

from __future__ import annotations

import torch

if torch.get_num_threads() != 1:
    torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # a parallel region already ran: the pool is fixed
    pass

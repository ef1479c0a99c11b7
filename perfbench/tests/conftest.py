"""One intra-op thread for each of the benchmark's CPU tests.

These tests build sweep drivers, which quantize a configuration's whole space
candidate by candidate: tens of thousands of small torch ops, each of which
may enter a parallel region.  Under pytest-xdist every worker's default
intra-op pool (a thread per core) competes with the other workers', and a
parallel region then waits on pool threads the scheduler has parked: a
1,800-candidate set-up took over 100x its time alone (0.8 s) beside five
busy workers, against ~8x on one thread.  The setting is restored after each
test, so tests of other directories on the same worker keep their pool.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)

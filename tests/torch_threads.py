"""Torch's intra-op threads in the port's test processes.

pytest-xdist runs the suite in W worker processes on one host, and torch
gives each of them one intra-op thread a core by default: W workers then
contend W-fold for every core, and a test that takes seconds alone can take
minutes beside five others. `capped_threads`, a module-scoped autouse
fixture that a port test file takes in by importing it, gives the module's
tests ``max(1, os.cpu_count() // W)`` threads (W = 1 outside xdist, where
nothing changes) and restores the count after the module. It only lowers
the count: the files that pin one thread for their runs keep doing so.

`tests/test_torch_eva_l14.py` does not take it: its one-step parity against
the JAX step holds an AdamW update, whose first step moves a weight by the
learning rate times the sign of its gradient, so a gradient entry that is
zero but for rounding moves by up to twice the rate on a change of the
matrix products' summation order; at one thread its
`visual.blocks.1.mlp.w3.weight` lands 2.4e-4 from the JAX step's (bar
1e-4), at torch's default thread count within the bar, as it always ran."""

from __future__ import annotations

import os

import pytest
import torch


def thread_share() -> int:
    """This process's share of the cores under pytest-xdist."""
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture(scope="module", autouse=True)
def capped_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, thread_share()))
    yield torch.get_num_threads()
    torch.set_num_threads(before)

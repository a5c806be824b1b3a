"""The hand-written kernels in a count of a step's work, and on fake
tensors.

Each kernel family's module has ``work(...) -> (flops, bytes)``: the
arithmetic of its bound (PERF.md §6, "Bounds") at given shapes, the
operations the algorithm needs and each input read and each output
written once.  Where that depends on the data (the W rows a sparse
batch touches, the gathers kernel 8's early stop leaves) ``work`` takes
the count as an argument and otherwise counts what the shapes allow at
most, which is what a count of a step records: it reads no data.

Each wrapper dispatches inside ``launch(name, work)``: to its kernel on
a CUDA tensor, its plain version on a CPU tensor, and, on a fake tensor
(``is_fake``: one of ``torch._subclasses.FakeTensorMode``, which has
shapes and no data, as in ``launch/dryrun.py``), to its stand-in, which
allocates the kernel's outputs with their shapes and dtypes and builds
and launches nothing.  An active counter (``launch/cost_analysis.py``)
records the work under the kernel's name and leaves out the aten ops
inside (the outputs' allocation, a sort that belongs to the launch, a
plain version's loop), so one step counts the same on the card, on the
CPU and on fake tensors.  A launch inside another counts once, as the
outer one.  Without an active counter ``launch`` records nothing.
"""

from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensor

# the active counters, innermost last (``cost_analysis.CostCounter``
# pushes itself while it is entered)
COUNTERS: list = []


def is_fake(x: torch.Tensor) -> bool:
    """Whether ``x`` is a fake tensor (shapes, dtypes and a device, no
    data): a wrapper then runs its kernel's stand-in."""
    return isinstance(x, FakeTensor)


@contextlib.contextmanager
def launch(name: str, work: tuple):
    """A kernel's launch for the block (its plain version's run, or its
    stand-in's on fake tensors): each active counter records ``work`` =
    (flops, bytes) under ``name`` and ignores the aten ops inside."""
    flops, nbytes = work
    for c in COUNTERS:
        c.enter_kernel(name, flops, nbytes)
    try:
        yield
    finally:
        for c in COUNTERS:
            c.exit_kernel()

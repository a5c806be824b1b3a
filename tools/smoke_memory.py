"""Run a checkout's ``chip_smoke.py`` up to the end of one phase on the
card, printing the CUDA caching allocator's state at every phase's entry
and exit: bytes allocated, bytes reserved and the difference, inactive
split blocks, segments, allocation retries (a failed allocation that
freed the cache and tried again) and out-of-memory errors.  An
out-of-memory error in a phase is caught, its state printed, and the
run stopped there.

The script run is the ``chip_smoke.py`` under ``--root`` (default: this
checkout), so that two checkouts can be held against each other on one
card in one call: unpack the other one with ``git archive`` into a
directory that ``.gitignore`` lists and run, for example,

    python3 tools/smoke_memory.py --root build/parent
    python3 tools/smoke_memory.py
    python3 tools/smoke_memory.py
    python3 tools/smoke_memory.py --root build/parent

The allocator's settings come from ``PYTORCH_CUDA_ALLOC_CONF`` as the
caller sets it; ``chip_smoke.py`` only sets a default where it is unset.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

GIB = 2 ** 30


class _Stop(Exception):
    pass


def allocator_state(tag: str) -> None:
    s = torch.cuda.memory_stats()
    a, r = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    print(f"memory {tag}: allocated {a / GIB:.2f} reserved {r / GIB:.2f} "
          f"reserved but unallocated {(r - a) / GIB:.2f} GiB, inactive "
          f"split {s.get('inactive_split_bytes.all.current', 0) / GIB:.2f} "
          f"GiB, segments {s.get('segment.all.current', 0)}, retries "
          f"{s.get('num_alloc_retries', 0)}, out of memory "
          f"{s.get('num_ooms', 0)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose chip_smoke.py runs")
    ap.add_argument("--last", default="phase_oaa",
                    help="the phase function after which the run stops")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(args.root) / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)

    def traced(name, fn):
        def run(*a, **kw):
            allocator_state(f"{name} entry")
            try:
                out = fn(*a, **kw)
            except torch.OutOfMemoryError as exc:
                allocator_state(f"{name} out of memory")
                print(f"{name}: {str(exc)[:400]}", flush=True)
                raise _Stop from exc
            allocator_state(f"{name} exit")
            if name == args.last:
                raise _Stop
            return out
        return run

    for name in list(vars(smoke)):
        if name.startswith("phase_") and callable(getattr(smoke, name)):
            setattr(smoke, name, traced(name, getattr(smoke, name)))
    try:
        return smoke.main()
    except _Stop:
        print("stopped", flush=True)
        return 0


if __name__ == "__main__":
    sys.exit(main())

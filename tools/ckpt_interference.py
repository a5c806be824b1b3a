"""What slows a training step while a checkpoint is written, on the card.

A checkpoint's background write (``CheckpointManager.save(blocking=
False)``) runs on a host thread beside the training loop.  This times
ODP training steps (``chip_smoke.py`` phase 16's: full width, nnz=120,
N=512, AdamW through ``Trainer.step_fn``, each step synchronized) while a
thread runs one of these, and with none:

* ``crc``    — ``zlib.crc32`` over a 1 GiB buffer, again and again;
* ``write``  — that buffer written to a file and fsynced, again and again;
* ``npz``    — the manager's own writer (``_write_npz``) on a 4 GB state;
* ``python`` — a pure-Python loop (holds the interpreter lock);
* ``save``   — ``CheckpointManager.save(blocking=False)`` of the training
  state itself, steps timed while its write is in flight; run twice
  (the first save page-locks its host buffers, the second reuses them).

Prints the median and largest step ms of each, with the card's name and
power limit.  Writes under a temporary directory it removes.

    PYTHONPATH=src python tools/ckpt_interference.py [--steps 20]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (sets the allocator's config first)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import manager as manager_mod  # noqa: E402


def _background(mode: str, stop: threading.Event, directory: str,
                state_arrays: list) -> None:
    buf = np.ones(1 << 30, np.uint8)
    path = os.path.join(directory, "background.bin")
    while not stop.is_set():
        if mode == "crc":
            zlib.crc32(buf)
        elif mode == "write":
            with open(path, "wb") as f:
                f.write(buf)
                f.flush()
                os.fsync(f.fileno())
        elif mode == "npz":
            manager_mod._write_npz(path, state_arrays)
        elif mode == "python":
            t_end = time.perf_counter() + 0.5
            while time.perf_counter() < t_end:
                pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ckpt_interference: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "tools"))
    from train_determinism import _odp
    trainer, _, state, stream = _odp(dev, 120)
    arrays = [np.asarray(x.detach().cpu()) for _, x in
              manager_mod.tree_flatten(state) if isinstance(x, torch.Tensor)]
    smi = cs._nvidia_smi()
    with tempfile.TemporaryDirectory(prefix="ckpt_interference_") as d:
        mgr = manager_mod.CheckpointManager(os.path.join(d, "ckpt"), keep=1)
        for i, mode in enumerate(("none", "crc", "write", "npz", "python",
                                  "save", "save", "none")):
            stop = threading.Event()
            th = (threading.Thread(target=_background,
                                   args=(mode, stop, d, arrays), daemon=True)
                  if mode not in ("none", "save") else None)
            if th is not None:
                th.start()
                time.sleep(0.5)
            if mode == "save":
                t0 = time.perf_counter()
                mgr.save(i, state, blocking=False)
                print(f"   save: held the step {time.perf_counter() - t0:.3f}"
                      f" s", flush=True)
            ms = []
            for s in range(args.steps):
                if mode == "save" and not mgr.in_flight():
                    break
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, _ = trainer.step_fn(state, stream.batch_at(s))
                torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            stop.set()
            if th is not None:
                th.join()
            mgr.wait()
            print(f"{mode:>7}: step ms median {statistics.median(ms):.3f}, "
                  f"max {max(ms):.3f}, first {ms[0]:.3f} ({len(ms)} steps) "
                  f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The host I/O rates a checkpoint of the port meets on this machine.

Times, for one 2 GiB float32 tensor on the card: the copy to pageable
host memory and to page-locked memory, ``np.savez`` of it to a file
under the temporary directory and the fsync after, ``np.load`` back,
and the copy back to the card; prints GB/s for each, the free space
under the temporary directory, and the card's name and power limit.

    python3 tools/io_probe.py
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def _rate(nbytes: int, t0: float) -> str:
    dt = time.perf_counter() - t0
    return f"{nbytes / dt / 1e9:.3f} GB/s ({dt:.3f} s)"


def main() -> int:
    if not torch.cuda.is_available():
        print("io_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    x = torch.randn(1 << 29, device="cuda")          # 2 GiB
    nbytes = x.numel() * x.element_size()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = x.to("cpu", copy=True)
    print("device to pageable host:", _rate(nbytes, t0))
    pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    t0 = time.perf_counter()
    pinned.copy_(x)
    print("device to page-locked host:", _rate(nbytes, t0))
    with tempfile.TemporaryDirectory(prefix="io_probe_") as d:
        print(f"free under {d}: {shutil.disk_usage(d).free / 1e9:.1f} GB")
        path = os.path.join(d, "a.npz")
        with open(path, "wb") as f:
            t0 = time.perf_counter()
            np.savez(f, leaf_0=host.numpy())
            f.flush()
            print("np.savez:", _rate(nbytes, t0))
            t0 = time.perf_counter()
            os.fsync(f.fileno())
            print("fsync:", _rate(nbytes, t0))
        t0 = time.perf_counter()
        back = np.load(path)["leaf_0"]
        print("np.load:", _rate(nbytes, t0))
    t0 = time.perf_counter()
    y = torch.from_numpy(back).to("cuda")
    torch.cuda.synchronize()
    print("pageable host to device:", _rate(nbytes, t0))
    print("same bits:", bool(torch.equal(x, y)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

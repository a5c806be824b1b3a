"""PyTorch + CUDA port of the MACH extreme-classification system.

Mirrors the module layout of the JAX package ``repro`` (configs, core,
kernels, data) with PyTorch idiom inside: plain functions on tensors,
explicit ``device=`` arguments and explicit ``torch.Generator``s.  The
Algorithm-2 decode kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use.

Entry points that create tensors run on ``cuda`` unless the caller
passes ``device="cpu"``; there is no silent CPU fallback.  Ops that take
tensors dispatch on the tensors' device: a CUDA tensor goes to the
kernel, a CPU tensor to the kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises if a CUDA device is asked for and
    none is available, so nothing silently runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

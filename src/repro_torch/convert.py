"""Carry MACH head weights from the JAX package into the port.

``convert_params`` takes a head's params as the JAX package stores them
(a dict of arrays — numpy, or anything ``np.asarray`` accepts) and
returns the port's dict of tensors on ``device``, after checking keys,
shapes and dtypes against the port's head of the same configuration:

* ``MACHLinear``:     {"w": (d, R, B), "b": (R, B)}
* ``MACHOutputHead``: {"kernel": (d, R·B)}

The layouts are the same in both packages, so both compute the same
function on the converted weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.mach import MACHHead, MACHLinear, MACHOutputHead


def expected_params(head: MACHHead) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Key -> (shape, dtype) of ``head``'s params."""
    c = head.cfg
    if isinstance(head, MACHLinear):
        return {"w": ((head.dim, c.num_repetitions, c.num_buckets), torch.float32),
                "b": ((c.num_repetitions, c.num_buckets), torch.float32)}
    if isinstance(head, MACHOutputHead):
        return {"kernel": ((head.dim, head.out_features), head.dtype)}
    raise TypeError(f"no parameter layout for {type(head).__name__}")


def convert_params(head: MACHHead, params: dict, device=None) -> dict:
    """JAX-package params (arrays) -> port params (tensors on ``device``)."""
    device = resolve_device(device)
    want = expected_params(head)
    if set(params) != set(want):
        raise ValueError(f"param keys {sorted(params)} != expected {sorted(want)}")
    out = {}
    for key, (shape, dtype) in want.items():
        arr = np.asarray(params[key])
        if arr.shape != shape:
            raise ValueError(f"param {key!r} has shape {arr.shape}, "
                             f"expected {shape}")
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
        if t.dtype != dtype:
            raise ValueError(f"param {key!r} has dtype {arr.dtype}, "
                             f"expected {dtype}")
        out[key] = t.to(device)
    return out

"""Carry weights from the JAX package into the port.

``convert_params`` takes a head's params as the JAX package stores them
(a dict of arrays — numpy, or anything ``np.asarray`` accepts) and
returns the port's dict of tensors on ``device``, after checking keys,
shapes and dtypes against the port's head of the same configuration:

* ``MACHLinear``:     {"w": (d, R, B), "b": (R, B)}
* ``MACHOutputHead``: {"kernel": (d, R·B)}
* ``OAAClassifier``:  {"w": (d, K), "b": (K,)}

``convert_lm_params`` does the same for a whole ``LanguageModel``, the
MACH head's kernel or the OAA head's ``lm_head`` among its leaves, and
an MoE block's ``moe`` subtree (router (d, E), wi / wg (E, d, f), wo
(E, f, d), the shared experts' MLP and ``shared_gate`` (d, 1)) stacked
on the layer axis like every block leaf.  The
layouts are the same in both packages, so both compute the same function
on the converted weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.mach import MACHHead, MACHLinear, MACHOutputHead
from repro_torch.core.oaa import OAAClassifier


def expected_params(head) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Key -> (shape, dtype) of ``head``'s params."""
    if isinstance(head, OAAClassifier):
        return {"w": ((head.dim, head.num_classes), torch.float32),
                "b": ((head.num_classes,), torch.float32)}
    c = head.cfg
    if isinstance(head, MACHLinear):
        return {"w": ((head.dim, c.num_repetitions, c.num_buckets), torch.float32),
                "b": ((c.num_repetitions, c.num_buckets), torch.float32)}
    if isinstance(head, MACHOutputHead):
        return {"kernel": ((head.dim, head.out_features), head.dtype)}
    raise TypeError(f"no parameter layout for {type(head).__name__}")


def convert_params(head: MACHHead | OAAClassifier, params: dict,
                   device=None) -> dict:
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


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; bfloat16 arrays (JAX's ml_dtypes) by bits."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def convert_lm_params(model, params, device=None):
    """The JAX ``LanguageModel.init`` params (a pytree of arrays, as
    numpy) -> the port's params for ``model`` on ``device``, leaf for
    leaf.  Raises on a missing or extra leaf, or a leaf whose shape or
    dtype differs from the port's."""
    device = resolve_device(device)
    want = model.init(device="meta")

    def walk(want_t, got_t, path):
        if isinstance(want_t, dict):
            got_keys = sorted(got_t) if isinstance(got_t, dict) else None
            if got_keys != sorted(want_t):
                raise ValueError(f"params{path}: keys {got_keys} != "
                                 f"expected {sorted(want_t)}")
            return {k: walk(want_t[k], got_t[k], f"{path}[{k!r}]")
                    for k in want_t}
        if isinstance(want_t, list):
            if not isinstance(got_t, (list, tuple)) or len(got_t) != len(want_t):
                raise ValueError(f"params{path}: expected a list of "
                                 f"{len(want_t)}")
            return [walk(w, g, f"{path}[{i}]")
                    for i, (w, g) in enumerate(zip(want_t, got_t))]
        t = _to_tensor(np.asarray(got_t))
        if tuple(t.shape) != tuple(want_t.shape) or t.dtype != want_t.dtype:
            raise ValueError(f"params{path}: {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(want_t.shape)} {want_t.dtype}")
        return t.to(device)

    return walk(want, params, "")

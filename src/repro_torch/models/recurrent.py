"""RG-LRU recurrent block (Griffin / recurrentgemma substrate).

Block layout (Griffin Fig. 2):
    x ─ linear_y ─ GeLU ─────────────────────┐
    x ─ linear_x ─ causal conv1d(4) ─ RG-LRU ┴ ⊙ ─ linear_out

RG-LRU (paper eq. 1-4):
    r_t = σ(W_a ξ_t);  i_t = σ(W_x ξ_t)
    log a_t = −c · softplus(Λ) ⊙ r_t                 (c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ ξ_t)

The recurrence runs through ``kernels/ops.lru_scan`` (kernel 9 on the
card).  Decode carries (conv tail, h) as state.  A state passed in is
updated in place and returned.  Under a sharded step the block may run
on a rank's channels (``apply_rglru_block(split=)``): every channel's
recurrence is its own, so kernel 9 on a rank's channels does the whole
kernel's work on them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.sharding import partitioning

_C = 8.0
_CONV_W = 4


class RecurrentState(NamedTuple):
    conv: torch.Tensor   # (B, CONV_W-1, W) trailing inputs
    h: torch.Tensor      # (B, W) float32 recurrence state


def init_rglru_block(generator, d_model: int, width: Optional[int], device
                     ) -> dict:
    w = width or d_model
    p = {"lin_y": layers.init_dense(generator, d_model, (w,), device),
         "lin_x": layers.init_dense(generator, d_model, (w,), device),
         "conv": {"w": layers.truncated_normal_init((_CONV_W, w), 1.0,
                                                    generator, device),
                  "b": torch.zeros((w,), dtype=torch.float32, device=device)},
         "gate_a": layers.init_dense(generator, w, (w,), device),
         "gate_x": layers.init_dense(generator, w, (w,), device)}
    # Λ init so that a^(1/r) spans ~[0.9, 0.999] (Griffin appendix)
    u = torch.empty((w,), dtype=torch.float32, device=device)
    u.uniform_(0.9, 0.999, generator=generator)
    p["lam"] = {"log": torch.log(torch.expm1(-torch.log(u) / _C))}
    p["lin_out"] = layers.init_dense(generator, w, (d_model,), device)
    return p


RGLRU_AXES = {"lin_y": layers.dense_axes("embed", ("mlp",)),
              "lin_x": layers.dense_axes("embed", ("mlp",)),
              "conv": {"w": (None, "mlp"), "b": ("mlp",)},
              "gate_a": layers.dense_axes("mlp", ("mlp",)),
              "gate_x": layers.dense_axes("mlp", ("mlp",)),
              "lam": {"log": ("mlp",)},
              "lin_out": layers.dense_axes("mlp", ("embed",))}


def _causal_conv(params: dict, x: torch.Tensor, tail: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel causal conv, width 4, taps flipped.  x: (B, T, W);
    tail: (B, 3, W) previous inputs, or None (from zero).  Returns
    (y, new_tail), the tail in x's dtype."""
    b, t, w = x.shape
    if tail is None:
        tail = torch.zeros((b, _CONV_W - 1, w), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)                 # (B, T+3, W)
    y = torch.zeros_like(x)
    cw = params["w"].to(x.dtype)
    for i in range(_CONV_W):
        y = y + xp[:, i:i + t] * cw[_CONV_W - 1 - i]
    y = y + params["b"].to(x.dtype)
    return y, xp[:, -(_CONV_W - 1):]


def _gate(params: dict, xi: torch.Tensor,
          split: Optional[partitioning.RangeSplit]) -> torch.Tensor:
    """A gate's pre-activation: xi @ W; on a split, the rank's rows of W
    give a partial (B, T, W), summed onto the rank's channels."""
    g = layers.dense(params, xi)
    return g if split is None else split.onto_range(g)


def _rglru(params: dict, xi: torch.Tensor, h0: torch.Tensor,
           split: Optional[partitioning.RangeSplit] = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """xi: (B, T, W) conv output; h0: (B, W).  Returns (h_seq in xi's
    dtype, h_last float32).  ``split``: xi and ``params`` hold the rank's
    channels (gate_a's and gate_x's rows)."""
    r = torch.sigmoid(_gate(params["gate_a"], xi, split).to(torch.float32))
    i = torch.sigmoid(_gate(params["gate_x"], xi, split).to(torch.float32))
    log_a = -_C * F.softplus(params["lam"]["log"]) * r          # (B, T, W)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bterm = mult * i * xi.to(torch.float32)
    h = ops.lru_scan(a, bterm, h0.to(torch.float32))
    return h.to(xi.dtype), h[:, -1].to(torch.float32)


def apply_rglru_block(params: dict, x: torch.Tensor,
                      state: Optional[RecurrentState] = None,
                      split: Optional[partitioning.RangeSplit] = None
                      ) -> tuple[torch.Tensor, RecurrentState]:
    """x: (B, T, d_model) -> (y, state).  ``state=None`` starts at zero
    and returns a new state; a given state is updated in place.

    ``split`` (a sharded step's ``BlockSplit.rglru``, no state; then
    ``params`` hold the rank's shards) computes the rank's channels
    [r0, r1): x goes into the split (dx summed over its ranks in the
    backward), lin_y, lin_x, the conv, Λ and kernel 9 run on its W/n
    channels, the gates on its rows (``_gate``), and the partial output
    of its rows of lin_out comes out summed, so y is whole."""
    if split is not None:
        x = split.into(x)
    b = x.shape[0]
    w = params["lin_y"]["kernel"].shape[1]
    ybr = layers.gelu(layers.dense(params["lin_y"], x))
    xbr = layers.dense(params["lin_x"], x)
    tail = state.conv if state is not None else None
    h0 = state.h if state is not None else torch.zeros(
        (b, w), dtype=torch.float32, device=x.device)
    xc, new_tail = _causal_conv(params["conv"], xbr, tail)
    hseq, h_last = _rglru(params, xc, h0, split)
    out = layers.dense(params["lin_out"], hseq * ybr)
    if split is not None:
        out = split.out_of(out)
    if state is None:
        return out, RecurrentState(conv=new_tail, h=h_last)
    state.conv.copy_(new_tail)
    state.h.copy_(h_last)
    return out, state


def init_recurrent_state(batch: int, width: int, dtype, device
                         ) -> RecurrentState:
    return RecurrentState(
        conv=torch.zeros((batch, _CONV_W - 1, width), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, width), dtype=torch.float32, device=device))

"""Shared neural-net layers (plain functions on dicts of tensors).

Every ``init_*`` returns a params dict with the JAX package's keys and
layouts (``repro/models/layers.py``), drawn from an explicit
``torch.Generator`` on ``device``; the two packages' draws differ, so
parity tests carry the JAX params across with ``convert.convert_lm_params``.
Each ``*_axes`` beside an init gives the same tree with the logical name
of every dim in place of each tensor (the JAX init's second result),
read by ``sharding/partitioning.py``:

  embed                 d_model
  mlp                   feed-forward hidden
  heads, kv_heads, qkv  attention projections (qkv = head_dim)
  vocab                 embedding / OAA softmax rows
  mach_rb               MACH head output (R·B)
  experts               MoE expert dimension
  layers                stacked layer dimension (never sharded)
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def truncated_normal_init(shape: Sequence[int], scale: float,
                          generator: Optional[torch.Generator], device,
                          dtype=torch.float32) -> torch.Tensor:
    """Fan-in scaled truncated normal on [-2, 2] (MaxText-style default):
    stddev = scale / max(1, sqrt(shape[0]))."""
    shape = tuple(shape)
    stddev = scale / max(1.0, math.sqrt(shape[0] if len(shape) else 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.to(dtype) * stddev


def init_dense(generator, in_dim: int, out_dims: Sequence[int], device,
               scale: float = 1.0) -> dict:
    """Dense kernel (in_dim, *out_dims) with fan-in init."""
    return {"kernel": truncated_normal_init((in_dim,) + tuple(out_dims), scale,
                                            generator, device)}


def dense_axes(in_axis, out_axes) -> dict:
    return {"kernel": (in_axis,) + tuple(out_axes)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ kernel (in, *out) -> (..., *out), in x's dtype."""
    k = params["kernel"].to(x.dtype)
    out = x @ k.reshape(k.shape[0], -1)
    return out.reshape(x.shape[:-1] + k.shape[1:])


def init_norm(dim: int, kind: str, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
                "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}
    raise ValueError(kind)


def norm_axes(kind: str, axis="embed") -> dict:
    return {k: (axis,) for k in (("scale",) if kind == "rmsnorm"
                                 else ("scale", "bias"))}


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """Norm in float32, times ``scale`` (not 1 + scale), back in x's dtype."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(x.dtype)


def init_embedding(generator, vocab: int, dim: int, device) -> dict:
    return {"embedding": truncated_normal_init((vocab, dim), 1.0, generator,
                                               device)}


EMBEDDING_AXES = {"embedding": ("vocab", "embed")}


def embed(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embedding"][tokens.long()].to(dtype)


def unembed(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits: h (..., d) @ embeddingᵀ -> (..., V), in h's
    dtype."""
    return h @ params["embedding"].to(h.dtype).T


# ---------------------------------------------------------------------------
# Activations / gated MLP
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACT = {"gelu": gelu, "relu": F.relu, "silu": F.silu, "tanh": torch.tanh}


def init_mlp(generator, d_model: int, d_ff: int, device,
             activation: str = "swiglu") -> dict:
    """Gated (swiglu/geglu) or plain MLP: wi, [wg], wo."""
    p = {"wi": init_dense(generator, d_model, (d_ff,), device)}
    if activation in ("swiglu", "geglu"):
        p["wg"] = init_dense(generator, d_model, (d_ff,), device)
    p["wo"] = init_dense(generator, d_ff, (d_model,), device)
    return p


def mlp_axes(activation: str = "swiglu") -> dict:
    a = {"wi": dense_axes("embed", ("mlp",))}
    if activation in ("swiglu", "geglu"):
        a["wg"] = dense_axes("embed", ("mlp",))
    a["wo"] = dense_axes("mlp", ("embed",))
    return a


def apply_mlp(params: dict, x: torch.Tensor,
              activation: str = "swiglu") -> torch.Tensor:
    h = dense(params["wi"], x)
    if activation == "swiglu":
        h = F.silu(dense(params["wg"], x)) * h
    elif activation == "geglu":
        h = gelu(dense(params["wg"], x)) * h
    else:
        h = ACT[activation](h)
    return dense(params["wo"], h)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding on halves (not interleaved pairs), angles in
    float32.  x: (..., T, H, hd); positions: (..., T)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq          # (..., T, half)
    cos = torch.cos(ang)[..., None, :]                           # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

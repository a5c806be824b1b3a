"""Attention substrate: MHA/GQA/MQA, full/local windows, KV caches.

Two execution paths, both the softmax attention of the JAX package's
``repro/models/attention.py``:

* ``_attend_dense`` — one materialized float32 score tensor (short
                      prefills and every decode step).
* the flash branch  — ``ops.flash_attention`` (kernel 10 on the card) at
                      prefill length T >= ``flash_threshold``, T a
                      multiple of ``min(chunk_q, T)``, where the JAX
                      package runs its jnp flash recurrence.

Decode uses a KV cache: linear for full attention, a ring buffer of
``window`` rows for local attention.  The cache functions write into the
cache's tensors in place and return the cache.

Shapes: activations (B, T, D); q (B, T, H, hd); k/v (B, S, KV, hd);
GQA groups G = H // KV fold as (B, T, KV, G, hd) in the dense path.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = float(torch.finfo(torch.float32).min)


def init_attention(generator, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, device) -> dict:
    """QKV + output projections: q (d, H, hd), k/v (d, KV, hd), o (H, hd, d)."""
    return {
        "q": layers.init_dense(generator, d_model, (num_heads, head_dim), device),
        "k": layers.init_dense(generator, d_model, (num_kv_heads, head_dim),
                               device),
        "v": layers.init_dense(generator, d_model, (num_kv_heads, head_dim),
                               device),
        "o": {"kernel": layers.truncated_normal_init(
            (num_heads, head_dim, d_model), 1.0, generator, device)},
    }


def _group(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, KV, G, hd)."""
    b, t, h, hd = q.shape
    return q.reshape(b, t, num_kv, h // num_kv, hd)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(B, Tq), (B, Sk) -> (B, 1, 1, Tq, Sk) additive float32 mask."""
    qp = q_pos[:, None, None, :, None]
    kp = k_pos[:, None, None, None, :]
    ok = kp >= 0                                   # -1 marks empty cache slots
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _attend_dense(q, k, v, q_pos, k_pos, causal, window, scale):
    """q: (B,T,KV,G,hd); k/v: (B,S,KV,hd) -> (B,T,KV,G,hd).  Products of
    the stored values, float32 sums (as JAX's preferred_element_type)."""
    qs = (q.to(torch.float32) * scale).to(q.dtype)
    s = torch.einsum("btkgh,bskh->bkgts", qs.to(torch.float32),
                     k.to(torch.float32))
    m = _mask(q_pos, k_pos, causal, window)        # (B,1,1,T,S)
    s = s + m
    p = torch.softmax(s, dim=-1)
    # fully-masked rows give a uniform softmax; zero them
    valid = torch.any(m > NEG_INF / 2, dim=-1, keepdim=True)
    p = torch.where(valid, p, 0.0)
    out = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           flash_threshold: int = 2048, chunk_q: int = 512) -> torch.Tensor:
    """Dispatching attention. q (B,T,H,hd), k/v (B,S,KV,hd) -> (B,T,H,hd).

    The flash branch hands q, k, v to ``ops.flash_attention``, which
    reads positions as 0..T-1 and 0..S-1: it is taken only for a
    self-attention prefill (T == S), whose positions are exactly those
    (the TPU kernel makes the same assumption)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    if t >= flash_threshold and t % min(chunk_q, t) == 0:
        if k.shape[1] != t:
            raise ValueError("the flash branch is a self-attention prefill: "
                             f"needs S == T, got S={k.shape[1]}, T={t}")
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    out = _attend_dense(_group(q, kvh), k, v, q_pos, k_pos, causal, window,
                        1.0 / math.sqrt(hd))
    return out.reshape(b, t, h, hd)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Linear or ring-buffer KV cache.

    k, v:      (B, S, KV, hd) — S = max_len (linear) or window (ring)
    positions: (B, S) int32 absolute positions; −1 = empty
    index:     (B,) int32 next write offset (absolute count of tokens)
    """
    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor
    index: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_cache(batch: int, capacity: int, num_kv: int, head_dim: int,
               dtype, device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, capacity, num_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, num_kv, head_dim), dtype=dtype,
                      device=device),
        positions=torch.full((batch, capacity), -1, dtype=torch.int32,
                             device=device),
        index=torch.zeros((batch,), dtype=torch.int32, device=device))


def cache_update_prefill(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor) -> KVCache:
    """Write a full prefill segment at the cache head (linear caches) or
    the last ``capacity`` tokens of it, rolled so that position p lives
    at row p mod capacity (ring caches).  In place."""
    t = k.shape[1]
    cap = cache.capacity
    if t <= cap:
        cache.k[:, :t] = k.to(cache.k.dtype)
        cache.v[:, :t] = v.to(cache.v.dtype)
        cache.positions[:, :t] = positions
    else:
        shift = t % cap
        cache.k.copy_(torch.roll(k[:, t - cap:].to(cache.k.dtype), shift, 1))
        cache.v.copy_(torch.roll(v[:, t - cap:].to(cache.v.dtype), shift, 1))
        cache.positions.copy_(torch.roll(positions[:, t - cap:], shift, 1))
    cache.index.add_(t)
    return cache


def cache_update_decode(cache: KVCache, k1: torch.Tensor, v1: torch.Tensor,
                        ring: bool, per_row: bool = False) -> KVCache:
    """Insert one token (B, 1, KV, hd), in place.

    ``per_row=False`` — lockstep decode: every row writes at row 0's
    index.  ``per_row=True`` — slot decode for the continuous-batching
    engine: row i writes at its own ``index[i]``.  Ring caches write at
    index mod capacity; a linear cache's write row is clamped to its
    last row, as ``dynamic_update_slice`` clamps in the JAX package (a
    free engine slot's index runs on past the capacity)."""
    idx = cache.index.to(torch.int64)                 # (B,)
    cap = cache.capacity
    if not per_row:
        idx = idx[:1].expand_as(idx)
    slot = torch.remainder(idx, cap) if ring else torch.clamp(idx, max=cap - 1)
    rows = torch.arange(idx.shape[0], device=idx.device)
    cache.k[rows, slot] = k1[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v1[:, 0].to(cache.v.dtype)
    cache.positions[rows, slot] = idx.to(torch.int32)
    cache.index.add_(1)
    return cache


def decode_attend(q1: torch.Tensor, cache: KVCache, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over the cache.  q1: (B, 1, H, hd)."""
    q_pos = cache.index[:, None] - 1          # position of the new token
    return attend(q1, cache.k, cache.v, q_pos, cache.positions,
                  causal=True, window=window, flash_threshold=1 << 62)

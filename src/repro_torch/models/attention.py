"""Attention substrate: MHA/GQA/MQA, full/local windows, KV caches.

Two execution paths, both the softmax attention of the JAX package's
``repro/models/attention.py``:

* ``_attend_dense`` — one materialized float32 score tensor (short
                      prefills and every decode step).
* the flash branch  — ``ops.flash_attention`` (kernel 10 on the card) at
                      query length T >= ``flash_threshold``, T a
                      multiple of ``min(chunk_q, T)``, where the JAX
                      package runs its jnp flash recurrence: causal or
                      windowed self-attention prefills, the encoder's
                      non-causal self-attention and cross-attention
                      (S != T).

Decode uses a KV cache: linear for full attention, a ring buffer of
``window`` rows for local attention, or a shared page pool with per-slot
page tables (``PagedKVCache``, the paged serving engine's linear caches).
The cache functions write into the cache's tensors in place and return
the cache.

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


ATTENTION_AXES = {"q": layers.dense_axes("embed", ("heads", "qkv")),
                  "k": layers.dense_axes("embed", ("kv_heads", "qkv")),
                  "v": layers.dense_axes("embed", ("kv_heads", "qkv")),
                  "o": {"kernel": ("heads", "qkv", "embed")}}


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
    reads positions as 0..T-1 and 0..S-1 (the TPU kernel makes the same
    assumption): it takes a self-attention prefill (T == S), whose
    positions are exactly those, or a non-causal, unwindowed call with
    S != T (cross-attention), whose mask does not read positions.  Every
    key is read, where the JAX package's flash recurrence skips the last
    S mod ``chunk_k`` keys when S > ``chunk_k`` (ROADMAP.md)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    if t >= flash_threshold and t % min(chunk_q, t) == 0:
        if k.shape[1] != t and (causal or window is not None):
            raise ValueError("the flash branch takes S != T only without a "
                             f"causal mask or window, got S={k.shape[1]}, "
                             f"T={t}, causal={causal}, window={window}")
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


# ---------------------------------------------------------------------------
# Paged KV cache (shared page pool + per-slot page tables)
# ---------------------------------------------------------------------------

# pages gathered per step of the paged decode walk (at most half a
# slot's table, so no step holds a slot's whole max_len strip)
PAGES_PER_STEP = 64


class PagedKVCache(NamedTuple):
    """Shared page pool with per-slot page tables.

    A slot holds a page table of pool indices instead of a worst-case
    ``max_len`` strip, so resident KV memory is ``num_pages × page_size``
    tokens whatever each slot's ``max_len``.

    k, v:       (num_pages + 1, page_size, KV, hd) — the pool, and one
                spare page at index ``num_pages`` that no slot ever owns:
                writes with no page of their own (free slots, an index past
                the table) land there, where the JAX package drops them
    positions:  (num_pages + 1, page_size) int32 absolute positions; −1 =
                empty or stale (freed pages keep their contents; masking
                is entirely position-driven)
    page_table: (num_slots, max_pages) int32 pool page ids; −1 =
                unassigned.  Logical token p of slot s lives at pool
                coordinate (page_table[s, p // page_size], p % page_size).
    index:      (num_slots,) int32 next absolute write position
    """
    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor
    page_table: torch.Tensor
    index: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[-4] - 1

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[-1]

    @property
    def num_slots(self) -> int:
        return self.index.shape[-1]


def init_paged_cache(num_slots: int, num_pages: int, page_size: int,
                     max_pages: int, num_kv: int, head_dim: int, dtype,
                     device) -> PagedKVCache:
    pool = (num_pages + 1, page_size)
    return PagedKVCache(
        k=torch.zeros(pool + (num_kv, head_dim), dtype=dtype, device=device),
        v=torch.zeros(pool + (num_kv, head_dim), dtype=dtype, device=device),
        positions=torch.full(pool, -1, dtype=torch.int32, device=device),
        page_table=torch.full((num_slots, max_pages), -1, dtype=torch.int32,
                              device=device),
        index=torch.zeros((num_slots,), dtype=torch.int32, device=device))


def paged_insert_prefill(cache: PagedKVCache, one: KVCache, slot: int,
                         pages: torch.Tensor) -> PagedKVCache:
    """Copy a freshly prefilled batch-1 contiguous cache into the pool
    pages reserved for ``slot``, in place.

    Every leaf of both may carry leading dims (the stacked-layer axis):
    ``cache`` (..., pool, ...) and ``one`` (..., 1, C, ...).  ``one``
    has capacity C = len(pages) · page_size (the engine prefills at a
    page-rounded capacity); its positions carry −1 past the prompt, so
    the padded tail of the last page is masked like empty cache rows.
    The slot's table row becomes ``pages`` followed by −1."""
    ps = cache.page_size
    lead = one.index.shape[:-1]
    npg = one.k.shape[-3] // ps
    assert npg * ps == one.k.shape[-3], (one.k.shape, ps)
    pages = pages.to(device=cache.k.device, dtype=torch.long)

    def paginate(strip):          # (..., 1, C, *rest) -> (..., npg, ps, *rest)
        rest = strip.shape[len(lead) + 2:]
        return strip.reshape(lead + (npg, ps) + rest)

    cache.k[..., pages, :, :, :] = paginate(one.k).to(cache.k.dtype)
    cache.v[..., pages, :, :, :] = paginate(one.v).to(cache.v.dtype)
    cache.positions[..., pages, :] = paginate(one.positions)
    cache.page_table[..., slot, :] = -1
    cache.page_table[..., slot, :npg] = pages.to(torch.int32)
    cache.index[..., slot] = one.index[..., 0]
    return cache


def paged_append_page(cache: PagedKVCache, slot: int, page_idx: int,
                      page_id: int) -> PagedKVCache:
    """Grow ``slot``'s table by one page (decode boundary crossing), in
    place, on every leading (layer) index at once."""
    cache.page_table[..., slot, page_idx] = page_id
    return cache


def paged_reset_slot(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Clear ``slot``: table row → −1, index → 0, in place.  Page contents
    stay stale on purpose: a prefill writes whole pages, and a decode
    write at page offset 0 rewrites the page's position row, so a
    recycled page's stale positions never reach the mask."""
    cache.page_table[..., slot, :] = -1
    cache.index[..., slot] = 0
    return cache


def paged_cache_update_decode(cache: PagedKVCache, k1: torch.Tensor,
                              v1: torch.Tensor) -> PagedKVCache:
    """Insert one token per slot (k1/v1: (S, 1, KV, hd)) at each slot's
    own (page, offset) = (table[s, idx // ps], idx % ps), in place.

    A slot whose table entry is unassigned (−1) — a free slot, or one
    whose index ran past its table — writes the spare page, which no
    slot reads: a free slot cannot touch a page it does not own.  A
    write at offset 0 rewrites the page's whole position row (the
    token's position at 0, −1 elsewhere), so a recycled page's stale
    positions never leak into the attention mask."""
    idx = cache.index.to(torch.int64)                    # (S,)
    ps, mp, npages = cache.page_size, cache.max_pages, cache.num_pages
    pj = torch.div(idx, ps, rounding_mode="floor")
    off = idx - pj * ps
    entry = torch.gather(cache.page_table, 1,
                         torch.clamp(pj, max=mp - 1)[:, None])[:, 0].long()
    valid = (entry >= 0) & (pj < mp)
    page = torch.where(valid, entry, npages)
    cur = torch.where(valid[:, None],
                      cache.positions[torch.where(valid, entry, 0)], -1)
    lane = torch.arange(ps, device=idx.device)[None]     # (1, ps)
    row = torch.where(lane == off[:, None], idx[:, None],
                      torch.where(off[:, None] == 0, -1, cur))
    cache.k[page, off] = k1[:, 0].to(cache.k.dtype)
    cache.v[page, off] = v1[:, 0].to(cache.v.dtype)
    cache.positions[page] = row.to(torch.int32)
    cache.index.add_(1)
    return cache


def paged_decode_attend(q1: torch.Tensor, cache: PagedKVCache, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a paged cache.  q1: (S, 1, H, hd).

    An online-softmax walk over the page table, ``PAGES_PER_STEP`` pages
    a step (at most half the table, so no step gathers a slot's whole
    strip): each step gathers an (S, P·page_size, KV, hd) tile and folds
    it into a running float32 (max, denominator, accumulator) — the JAX
    package's page-by-page recurrence with P pages to a chunk.  No
    intermediate carries both the slot dim and max_len = max_pages ·
    page_size.  Cast points as there: q is scaled in float32 and rounded
    to q's dtype, masked scores sit at float32's most negative value, e
    is rounded to v's dtype before P·V, and rows with no weight are 0.

    Unassigned table entries gather page 0 with positions −1, so a slot
    only ever attends to its own pages."""
    s_dim, _, h, hd = q1.shape
    kv = cache.k.shape[2]
    g = h // kv
    ps, mp = cache.page_size, cache.max_pages
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hd)
    qc = (_group(q1, kv).to(f32) * scale).to(q1.dtype).to(f32)
    q_pos = cache.index[:, None] - 1                     # (S, 1)
    m_run = torch.full((s_dim, kv, g, 1), NEG_INF, dtype=f32, device=q1.device)
    l_run = torch.zeros((s_dim, kv, g, 1), dtype=f32, device=q1.device)
    acc = torch.zeros((s_dim, kv, g, 1, hd), dtype=f32, device=q1.device)
    step = min(PAGES_PER_STEP, max(1, (mp + 1) // 2))
    for j in range(0, mp, step):
        pid = cache.page_table[:, j:j + step].long()     # (S, P)
        ok = pid >= 0
        safe = torch.where(ok, pid, 0)
        n = pid.shape[1] * ps
        kb = cache.k[safe].reshape(s_dim, n, kv, hd)
        vb = cache.v[safe].reshape(s_dim, n, kv, hd)
        kp = torch.where(ok[..., None], cache.positions[safe], -1)
        s = torch.einsum("btkgh,bskh->bkgts", qc, kb.to(f32))
        s = s + _mask(q_pos, kp.reshape(s_dim, n), True, window)
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
        corr = torch.exp(m_run - m_new)
        e = torch.exp(s - m_new[..., None])
        l_run = l_run * corr + torch.sum(e, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgts,bskh->bkgth", e.to(vb.dtype).to(f32), vb.to(f32))
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-37)[..., None]
    out = torch.where((l_run > 0)[..., None], out, 0.0)
    out = out.permute(0, 3, 1, 2, 4)                     # (S, 1, KV, G, hd)
    return out.reshape(s_dim, 1, h, hd).to(q1.dtype)

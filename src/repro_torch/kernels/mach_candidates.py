"""Count-min candidate-filtered MACH top-k decode (cost independent of K).

The streaming top-k (``mach_topk``) scores all K classes.  This path
scores only candidates:

  1. per repetition, the top-m buckets of the (N, R, B) probabilities
     (``bucket_topm``; kernel 7) and tau, the m-th largest value;
  2. the pool: the concatenation of the R·m inverted-table rows
     ``r·B + ids[r, i]`` in (r, i) order — P = R·m·L entries, the padded
     slots holding class id K, which is never claimed;
  3. per pool entry (``mach_candidate_topk_plain``; kernel 8): the R
     bucket values g[r], member[r] = g[r] >= tau[r] (a test on the value,
     not on the bucket id), count = Σ member, first = the lowest r with
     member[r].  The entry in chunk c is *claimed* iff first == c // m,
     so a class is claimed at most once.  On ties at tau, first can name
     a repetition whose chunk does not hold the class, which is then
     never claimed: that is the TPU kernel's behaviour, reproduced here
     (the brute-force oracle differs from it only on such ties).
     Valid = claimed (t <= 1) or claimed and count >= t;
  4. the top-k of the claimed entries on the key (band, value, class
     id): band 2 = valid, 1 = claimed but count < t (the backfill band),
     0 = dead; within a band value descending, then class id ascending.
     The value is the selection score — the raw sum over r in
     increasing order for unbiased (the streaming kernel's key), the min,
     or the median — so the order does not depend on the schedule, and
     at (m, t) = (B, R) the answer equals the streaming one bit for bit;
  5. ``finish_candidates``: s on the estimator's scale for valid slots,
     (-inf, -1) for the rest, except that a row with no valid candidate
     keeps its best backfill in slot 0 at ``(s - OFFSET) + OFFSET`` —
     the answer of the JAX package's penalty encoding
     (``s - OFFSET·(1-valid)`` for claimed entries, ``NEG_INF`` for dead
     ones) and ``decode_penalty_topk``, which the band makes unneeded
     here; ``decode_penalty_topk`` is kept for parity with that
     encoding.

On a CUDA tensor ``mach_candidate_topk`` launches the kernels of
``csrc/mach_candidates.cu`` (which replace the TPU kernels
``repro/kernels/mach_candidates.py::bucket_topm_pallas`` and
``::mach_candidate_topk_pallas``); on a CPU tensor it runs the plain
versions, which work through rows and pool entries in blocks so their
working set stays under about 1 GB at any shape; on a fake tensor the
kernels' stand-ins (``counting``).  Neither path has a
counterpart of the JAX pure path's ``compact_cap`` (a workaround for
XLA:CPU that bounds its min/median to a count-prioritized compaction):
like the TPU kernel and the oracle, both score the whole pool.  Hash
sources as in ``mach_decode``: the (R, K) table or inline
multiply-shift.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.estimators import ESTIMATORS, median_over_first
from repro_torch.kernels import _build, counting
from repro_torch.kernels.mach_decode import (_SMEM_OPTIN, check_cuda_operands,
                                             check_decode_operands)
from repro_torch.kernels.mach_topk import MAX_K, _next_pow2, unbiased_affine

# Penalty subtracted from backfill (count < t) scores: every estimator
# score lies in (-1/(B-1), 1], so backfill sorts below every valid
# entry and far above NEG_INF / 2 (dead).
OFFSET = 4.0
NEG_INF = torch.finfo(torch.float32).min
MAX_CLASSES = (1 << 30) - 1   # class ids fill 30 bits of the key (csrc kIdBits)
MAX_KCAP = 128                # largest kcap kernel 8 takes (csrc kMaxKCand)
_CAND_WARPS = 8               # kernel 8: warps a block (csrc kCandWarps)
_MERGE_MAX = 4096             # largest split-merge width (num_splits * kcap)
_PLAIN_ENTRIES = 1 << 22      # pool entries the plain version scores at once
_DEAD = -(1 << 63)            # the plain version's key of a dead entry


def validate_candidate_args(num_classes: int, k: int, m: int, t: int,
                            r: int, b: int, estimator: str) -> None:
    if estimator not in ESTIMATORS:
        raise ValueError(f"estimator must be one of {ESTIMATORS}, "
                         f"got {estimator!r}")
    if not 1 <= k <= num_classes:
        raise ValueError(f"need 1 <= k <= num_classes, got k={k}, "
                         f"num_classes={num_classes}")
    if not 1 <= m <= b:
        raise ValueError(f"need 1 <= m <= B, got m={m}, B={b}")
    if not 1 <= t <= r:
        raise ValueError(f"need 1 <= t <= R, got t={t}, R={r}")


def _check_limits(num_classes: int, k: int) -> None:
    """The kernels' limits, held on both paths so both take the same
    inputs (R <= 32 is ``check_decode_operands``')."""
    if k > MAX_K:
        raise ValueError(f"k={k} > {MAX_K}, the largest k the candidate "
                         f"kernel takes")
    if num_classes > MAX_CLASSES:
        raise ValueError(f"num_classes={num_classes} > {MAX_CLASSES}: class "
                         f"ids must fit the kernel's 30-bit key field")


def _check_inverted(inverted: torch.Tensor, r: int, b: int,
                    device: torch.device) -> None:
    if inverted.dim() != 2 or inverted.shape[0] != r * b or inverted.shape[1] < 1:
        raise ValueError(f"inverted must be (R·B, L)=({r * b}, L), got "
                         f"{tuple(inverted.shape)}")
    if inverted.device != device:
        raise ValueError("inverted and meta_probs are on different devices")


# ---------------------------------------------------------------------------
# Kernel 7: per-repetition bucket top-m.
# ---------------------------------------------------------------------------

def topm_work(n: int, r: int, b: int, m: int) -> tuple[int, int]:
    """(flops, bytes) of kernel 7: a comparison a probability (N·R·B);
    the probabilities read, tau and the m ids a repetition written."""
    return n * r * b, 4 * n * r * b + 4 * n * r * (1 + m)


def work(n: int, r: int, b: int, m: int, ell: int, k: int,
         num_classes: int, table: bool, gathers: Optional[int] = None,
         rows: Optional[int] = None, classes: Optional[int] = None
         ) -> tuple[int, int]:
    """(flops, bytes) of kernel 8: one float32 operation a probability
    value it gathers (``gathers``: ``pool_gathers`` on given inputs;
    without them the most the shapes allow, R values for each of the
    N·R·m·L pool entries); the probabilities, tau and ids read, the
    ``rows`` distinct inverted rows the batch touches (at most
    min(R·B, N·R·m)) read once, in table mode the table entries of the
    ``classes`` in them (at most min(K, rows·L)), and k (value, band,
    id) triples a query written."""
    if gathers is None:
        gathers = n * r * m * ell * r
    if rows is None:
        rows = min(r * b, n * r * m)
    if table and classes is None:
        classes = min(num_classes, rows * ell)
    nbytes = 4 * n * r * b + 4 * n * r * (1 + m) + 4 * rows * ell + 12 * n * k
    return gathers, nbytes + (4 * r * classes if table else 0)

def bucket_topm(meta_probs: torch.Tensor, m: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 7: (N, R, B) -> (tau (N, R) f32, ids
    (N, R, m) int32).  ids are the top-m buckets, ties to the lowest
    bucket id (a stable sort, as ``lax.top_k``; ``torch.topk`` promises
    no tie order); tau is the m-th largest value."""
    b = meta_probs.shape[-1]
    if not 1 <= m <= b:
        raise ValueError(f"need 1 <= m <= B, got m={m}, B={b}")
    val, idx = torch.sort(meta_probs.to(torch.float32), dim=-1,
                          descending=True, stable=True)
    return (val[..., m - 1].contiguous(),
            idx[..., :m].to(torch.int32).contiguous())


TOPM_PATHS = ("select", "warp", "block")        # csrc TopmPath


class TopmLayout(NamedTuple):
    path: str          # one of TOPM_PATHS
    keys: int          # keys a lane keeps (select) or sorts (warp), or the
                       # block sorts (block); a power of two


def topm_layout(b: int, m: int) -> TopmLayout:
    """Which kernel 7 runs a row of B values with m kept.

    "select" (each lane keeps its best next_pow2(m) keys of the values it
    streams, then m warp arg-max rounds; the kernel shares a row of more
    than 1,024 values among a block's warps) for m <= 32 wherever B >
    1,024, and for B <= 1,024 where a lane's list is no longer than the
    keys it would sort, next_pow2(B) / 32, and that is at least 2: the
    cut that tools/time_top1_topm.py --sweep measured on an H100.  Else,
    B <= 1,024: "warp", a bitonic sort in one warp's registers,
    next_pow2(B) / 32 keys a lane (at least 1).  Else "block", the
    next_pow2(B) keys sorted in shared memory (8 bytes a key), which must
    fit."""
    if not 1 <= m <= b:
        raise ValueError(f"need 1 <= m <= B, got m={m}, B={b}")
    if b <= 1024:
        lane_keys = max(1, _next_pow2(b) // 32)
        if 2 <= lane_keys and _next_pow2(m) <= lane_keys:
            return TopmLayout("select", _next_pow2(m))
        return TopmLayout("warp", lane_keys)
    if m <= 32:
        return TopmLayout("select", _next_pow2(m))
    width = _next_pow2(b)
    if 8 * width > _SMEM_OPTIN:
        raise ValueError(f"B={b} buckets do not fit in shared memory for "
                         f"m={m} > 32")
    return TopmLayout("block", width)


def bucket_topm_cuda(meta_probs: torch.Tensor, m: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel 7 on ``meta_probs``' stream, on the path
    ``topm_layout`` picks.  ``bucket_topm_cuda.launches`` counts the
    launches."""
    if meta_probs.dim() != 3 or meta_probs.device.type != "cuda":
        raise ValueError("bucket_topm_cuda needs CUDA meta_probs (N, R, B)")
    if meta_probs.dtype != torch.float32 or not meta_probs.is_contiguous():
        raise ValueError("meta_probs must be contiguous float32")
    n, r, b = meta_probs.shape
    layout = topm_layout(b, m)
    dev = meta_probs.device
    tau = torch.empty((n, r), dtype=torch.float32, device=dev)
    ids = torch.empty((n, r, m), dtype=torch.int32, device=dev)
    lib = _build.load("mach_candidates")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.bucket_topm_launch(meta_probs.data_ptr(), n, r, b, m,
                                      TOPM_PATHS.index(layout.path),
                                      layout.keys, tau.data_ptr(),
                                      ids.data_ptr(), stream)
    _build.check(lib, code, "bucket_topm")
    bucket_topm_cuda.launches += 1
    return tau, ids


bucket_topm_cuda.launches = 0


def bucket_topm_fake(meta_probs: torch.Tensor, m: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7's stand-in on fake tensors: tau (N, R) f32, ids (N, R, m)
    int32; nothing built or launched."""
    n, r, _ = meta_probs.shape
    return (meta_probs.new_empty((n, r), dtype=torch.float32),
            meta_probs.new_empty((n, r, m), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Shared pieces: chunk ids and the penalty-offset decode.
# ---------------------------------------------------------------------------

def candidate_chunks(ids: torch.Tensor, b: int) -> torch.Tensor:
    """Top-m bucket ids (N, R, m) -> inverted-table row ids (N, R·m)."""
    n, r, m = ids.shape
    rep = torch.arange(r, dtype=torch.int32, device=ids.device)
    return (rep[None, :, None] * b + ids).reshape(n, r * m)


def decode_penalty_topk(val: torch.Tensor, idx: torch.Tensor, t: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode the penalty-offset encoding after the top-k, as the JAX
    package does.  Valid entries pass through; dead ones become
    (-inf, -1); backfill entries are dropped, except that a row with no
    valid entry keeps its best backfill in slot 0 (score + OFFSET)."""
    if t <= 1:
        dead = val <= NEG_INF / 2
        return (torch.where(dead, -torch.inf, val),
                torch.where(dead, -1, idx))
    is_valid = val > -OFFSET / 2
    is_claimed = val > NEG_INF / 2
    keep0 = ~is_valid[:, :1] & is_claimed[:, :1]
    out_val = torch.where(is_valid, val, -torch.inf)
    out_idx = torch.where(is_valid, idx, -1)
    out_val[:, :1] = torch.where(keep0, val[:, :1] + OFFSET, out_val[:, :1])
    out_idx[:, :1] = torch.where(keep0, idx[:, :1], out_idx[:, :1])
    return out_val, out_idx


def finish_candidates(sel: torch.Tensor, band: torch.Tensor, idx: torch.Tensor,
                      r: int, b: int, estimator: str
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(selection value, band, class id) top-k -> (val, idx) on the
    estimator's scale (Eq. 2's affine map for unbiased, as the streaming
    op applies it).  Valid slots pass; the rest become (-inf, -1), except
    that a row with no valid slot (the keys rank valid first, so slot 0
    then holds a backfill) keeps its best backfill in slot 0 at
    ``(s - OFFSET) + OFFSET``, the value ``decode_penalty_topk`` restores
    from the JAX package's encoding."""
    s = unbiased_affine(sel, r, b) if estimator == "unbiased" else sel
    keep = band == 2
    back0 = band[:, :1] == 1
    val = torch.where(keep, s, -torch.inf)
    val[:, :1] = torch.where(back0, (s[:, :1] - OFFSET) + OFFSET, val[:, :1])
    keep[:, :1] |= back0
    return val, torch.where(keep, idx, -1)


# ---------------------------------------------------------------------------
# Kernel 8, plain version: keys of the pool entries, a running top-k.
# ---------------------------------------------------------------------------

def _pack_keys(band: torch.Tensor, sel: torch.Tensor, cls: torch.Tensor
               ) -> torch.Tensor:
    """int64 keys ordered as (band, value, -class id): the kernel's
    unsigned key minus 2^63.  -0.0 ranks as +0.0."""
    bits = (sel + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.where(bits >= 1 << 31, 0xFFFFFFFF - bits, bits + (1 << 31))
    return ((band.to(torch.int64) - 2) * (1 << 62) + order * (1 << 30)
            + (MAX_CLASSES - cls))


def _unpack_keys(key: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keys -> (selection value f32, band int32, class id int32); dead
    keys give (-inf, 0, -1)."""
    band = (key >> 62) + 2
    order = (key >> 30) & 0xFFFFFFFF
    bits = torch.where(order >= 1 << 31, order - (1 << 31), 0xFFFFFFFF - order)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    sel = bits.to(torch.int32).view(torch.float32)
    cls = MAX_CLASSES - (key & MAX_CLASSES)
    dead = band == 0
    return (torch.where(dead, -torch.inf, sel), band.to(torch.int32),
            torch.where(dead, -1, cls).to(torch.int32))


def _buckets(j: int, cls: torch.Tensor, table: Optional[torch.Tensor],
             coeffs: Optional[torch.Tensor], shift: Optional[int]
             ) -> torch.Tensor:
    """h_j(cls) as int64, from the table or by multiply-shift."""
    if table is not None:
        return table[j][cls].to(torch.int64)
    return ((coeffs[j].to(torch.int64) * cls) & 0xFFFFFFFF) >> shift


def _score(g: torch.Tensor, estimator: str) -> torch.Tensor:
    """(R, M) bucket values -> (M,) selection score, in the kernel's
    arithmetic: the sum over r in increasing order, the min, or the
    midpoint of the two middle order statistics."""
    if estimator == "median":
        return median_over_first(g)
    s = g[0]
    for j in range(1, g.shape[0]):
        s = s + g[j] if estimator == "unbiased" else torch.minimum(s, g[j])
    return s


def _pool_blocks(n: int, p_pool: int, dev: torch.device):
    """(first row, end row, pool positions) blocks of about
    ``_PLAIN_ENTRIES`` entries, a row block's entry blocks in turn."""
    rows_per = max(1, _PLAIN_ENTRIES // p_pool)
    e_blk = min(p_pool, max(1, _PLAIN_ENTRIES // rows_per))
    for lo in range(0, n, rows_per):
        for e0 in range(0, p_pool, e_blk):
            yield (lo, min(n, lo + rows_per),
                   torch.arange(e0, min(p_pool, e0 + e_blk), device=dev))


def _block_members(meta, tau, chunks, inverted, pos, m, num_classes, table,
                   coeffs, shift):
    """Pool entries ``pos`` (E,) of a block of rows: class ids (rows, E)
    (0 in padding), live (not padding), the member count, the first
    member repetition (R when none) and the chunk's repetition (E,)."""
    r = meta.shape[1]
    ell = inverted.shape[1]
    c = pos // ell
    rep = c // m
    pool = inverted[chunks[:, c], (pos - c * ell)[None, :]].to(torch.int64)
    live = (pool >= 0) & (pool < num_classes)
    cls = torch.where(live, pool, 0)
    count = torch.zeros_like(cls)
    first = torch.full_like(cls, r)
    for j in range(r):
        g = torch.gather(meta[:, j], 1, _buckets(j, cls, table, coeffs, shift))
        member = g >= tau[:, j, None]
        count += member
        first = torch.where((first == r) & member, j, first)
    return cls, live, count, first, rep


def _block_keys(meta, tau, chunks, inverted, pos, m, num_classes, t,
                estimator, table, coeffs, shift) -> torch.Tensor:
    """Keys (rows, E) of pool entries ``pos`` (E,) for a block of rows."""
    r = meta.shape[1]
    cls, live, count, first, rep = _block_members(
        meta, tau, chunks, inverted, pos, m, num_classes, table, coeffs, shift)
    rr, pp = torch.nonzero(live & (first == rep[None, :]), as_tuple=True)
    won = cls[rr, pp]
    g = torch.stack([meta[rr, j, _buckets(j, won, table, coeffs, shift)]
                     for j in range(r)])                      # (R, M)
    band = torch.full_like(won, 2)
    if t > 1:
        band = torch.where(count[rr, pp] >= t, 2, 1)
    keys = torch.full_like(cls, _DEAD)
    keys[rr, pp] = _pack_keys(band, _score(g, estimator), won)
    return keys


def mach_candidate_topk_plain(meta_probs: torch.Tensor, tau: torch.Tensor,
                              ids: torch.Tensor, inverted: torch.Tensor,
                              table: Optional[torch.Tensor] = None, *,
                              num_classes: int, k: int, t: int = 1,
                              estimator: str = "unbiased",
                              inline_coeffs: Optional[torch.Tensor] = None,
                              inline_shift: Optional[int] = None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of kernel 8.  meta (N, R, B), tau (N, R), ids
    (N, R, m) from ``bucket_topm``, inverted (R·B, L) -> (selection value
    (N, k) f32, band (N, k) int32, class id (N, k) int32), best first on
    the key; dead slots are (-inf, 0, -1).  Rows and pool entries go in
    blocks of about ``_PLAIN_ENTRIES`` entries, merged into a running
    top-k (claimed keys are unique, so its order is the key's)."""
    meta = meta_probs.to(torch.float32)
    n, r, b = meta.shape
    m = ids.shape[-1]
    dev = meta.device
    runs = {}
    for lo, hi, pos in _pool_blocks(n, r * m * inverted.shape[1], dev):
        chunks = candidate_chunks(ids[lo:hi], b).to(torch.int64)
        keys = _block_keys(meta[lo:hi], tau[lo:hi], chunks, inverted, pos, m,
                           num_classes, t, estimator, table, inline_coeffs,
                           inline_shift)
        run = runs.get(lo, torch.full((hi - lo, k), _DEAD, dtype=torch.int64,
                                      device=dev))
        runs[lo] = torch.topk(torch.cat([run, keys], dim=1), k, dim=1).values
    return _unpack_keys(torch.cat(list(runs.values())))


def live_repetitions(meta_probs: torch.Tensor, tau: torch.Tensor,
                     m: int) -> torch.Tensor:
    """(N,) the repetitions whose chunks kernel 8 walks: where m = B, up to
    and including the first repetition j in which every bucket is a member
    (every value >= tau[j], as when tau is the row's minimum): every class
    meets a member repetition there or earlier, so no entry of a later
    repetition's chunk is claimed and the kernel skips those chunks.  R
    where m < B or no repetition is all members."""
    n, r, b = meta_probs.shape
    if m != b:
        return torch.full((n,), r, dtype=torch.int64, device=meta_probs.device)
    every = (meta_probs.to(torch.float32) >= tau[..., None]).all(-1)   # (N, R)
    first = torch.where(every.any(-1), every.to(torch.int8).argmax(-1), r - 1)
    return first.to(torch.int64) + 1


def pool_gathers(meta_probs: torch.Tensor, tau: torch.Tensor,
                 ids: torch.Tensor, inverted: torch.Tensor,
                 table: Optional[torch.Tensor] = None, *, num_classes: int,
                 inline_coeffs: Optional[torch.Tensor] = None,
                 inline_shift: Optional[int] = None) -> int:
    """The probability values kernel 8 needs on these inputs, its work
    count: R for a claimed entry; for another live entry of a chunk of
    repetition r0, one for each repetition up to its first member one
    when that is below r0 (the test at r0 is the chunk's own bucket, one
    value a chunk, which kills the whole chunk or none of it); none for
    padding, a dead chunk or the chunks past ``live_repetitions``.  Inputs
    as ``mach_candidate_topk_plain``."""
    meta = meta_probs.to(torch.float32)
    n, r, b = meta.shape
    m = ids.shape[-1]
    reps = live_repetitions(meta, tau, m)
    total = 0
    for lo, hi, pos in _pool_blocks(n, r * m * inverted.shape[1], meta.device):
        chunks = candidate_chunks(ids[lo:hi], b).to(torch.int64)
        _, live, _, first, rep = _block_members(
            meta[lo:hi], tau[lo:hi], chunks, inverted, pos, m, num_classes,
            table, inline_coeffs, inline_shift)
        rep = rep[None, :]
        need = torch.where(first == rep, r,
                           torch.where(first < rep, first + 1, 0))
        live &= rep < reps[lo:hi, None]
        total += int(need[live].sum())
    return total


class CandLayout(NamedTuple):
    splits: int          # blocks a query
    kcap: int            # keys a block keeps: next_pow2(k)
    lane_keys: int       # keys a lane holds of its warp's list: 1 or 4
    smem_probs: bool     # the query's R·B probabilities in shared memory
    smem_bytes: int      # dynamic shared memory a block


def cand_layout(n: int, r: int, b: int, m: int, ell: int, k: int,
                sms: int) -> CandLayout:
    """How kernel 8 covers N queries on a card of ``sms`` SMs.

    A block is 8 warps; a warp walks whole chunks of one query, the
    chunks strided over the query's ``splits`` blocks.  The chunks that
    can claim are R·m, or m where m = B (then only repetition 0's, see
    ``live_repetitions``).  ``splits``: one wave of four blocks an SM
    (4·sms // N, at least 1), but no more blocks than give each warp a
    chunk, splits · kcap within the merge kernel's 4,096 keys, and, where
    the block stages the probabilities, at least R·B / 8 pool entries a
    block, to pay for the copy.  The probabilities go to shared memory
    when they fit beside the warps' lists (8 warps · 32 · lane_keys
    keys), else the kernel reads them from global memory (L2): the
    gate's R·B = 131,072.  ``lane_keys``: 1 for kcap <= 32, else 4
    (kcap <= 128)."""
    if not 1 <= k <= MAX_KCAP:
        raise ValueError(f"need 1 <= k <= {MAX_KCAP}, got {k}")
    kcap = _next_pow2(k)
    lane_keys = 1 if kcap <= 32 else 4
    lists = 8 * _CAND_WARPS * 32 * lane_keys
    smem_probs = lists + 4 * r * b <= _SMEM_OPTIN
    chunks = m if m == b else r * m
    splits = min(4 * sms // n, -(-chunks // _CAND_WARPS), _MERGE_MAX // kcap)
    if smem_probs:
        splits = min(splits, 8 * chunks * ell // (r * b))
    splits = max(1, splits)
    return CandLayout(splits, kcap, lane_keys, smem_probs,
                      lists + (4 * r * b if smem_probs else 0))


# ---------------------------------------------------------------------------
# Kernel 8, CUDA.
# ---------------------------------------------------------------------------

def mach_candidate_topk_cuda(meta_probs: torch.Tensor, tau: torch.Tensor,
                             ids: torch.Tensor, inverted: torch.Tensor,
                             table: Optional[torch.Tensor] = None, *,
                             num_classes: int, k: int, t: int = 1,
                             estimator: str = "unbiased",
                             inline_coeffs: Optional[torch.Tensor] = None,
                             inline_shift: Optional[int] = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch kernel 8 (filtered gather + score + per-block top-k, then
    the split merge) on ``meta_probs``' stream, laid out by
    ``cand_layout``.  Inputs and outputs as ``mach_candidate_topk_plain``;
    tensors contiguous on one card (meta and tau f32, ids and inverted
    int32, table int32 or coeffs int64); ``inverted`` is the inverted
    table of the same hash (the kernel takes every entry of chunk r0 to
    lie in its bucket at repetition r0).
    ``mach_candidate_topk_cuda.launches`` counts the launches."""
    check_cuda_operands(meta_probs, table, num_classes, inline_coeffs,
                        inline_shift)
    n, r, b = meta_probs.shape
    m = ids.shape[-1]
    validate_candidate_args(num_classes, k, m, t, r, b, estimator)
    _check_limits(num_classes, k)
    _check_inverted(inverted, r, b, meta_probs.device)
    for name, x, shape, dtype in (("tau", tau, (n, r), torch.float32),
                                  ("ids", ids, (n, r, m), torch.int32),
                                  ("inverted", inverted, tuple(inverted.shape),
                                   torch.int32)):
        if tuple(x.shape) != shape or x.dtype != dtype or \
                not x.is_contiguous() or x.device != meta_probs.device:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {meta_probs.device}")
    ell = inverted.shape[1]
    p_pool = r * m * ell
    if p_pool >= 1 << 31:
        raise ValueError(f"pool of R·m·L={p_pool} entries exceeds 2^31")
    dev = meta_probs.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    layout = cand_layout(n, r, b, m, ell, k, sms)
    kcap, splits = layout.kcap, layout.splits
    width = _next_pow2(splits * kcap)
    # a class's R bucket ids side by side for the kernel's random reads
    table_t = table.t().contiguous() if table is not None else None
    part = torch.empty((n, splits, kcap), dtype=torch.int64, device=dev)
    sel = torch.empty((n, k), dtype=torch.float32, device=dev)
    band = torch.empty((n, k), dtype=torch.int32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    lib = _build.load("mach_candidates")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mach_candidate_topk_launch(
            meta_probs.data_ptr(), tau.data_ptr(), ids.data_ptr(),
            inverted.data_ptr(), n, r, b, m, ell, num_classes,
            table_t.data_ptr() if table is not None else None,
            inline_coeffs.data_ptr() if table is None else None,
            inline_shift if table is None else 0,
            ESTIMATORS.index(estimator), t, k, kcap, layout.lane_keys, splits,
            width, int(layout.smem_probs), part.data_ptr(), sel.data_ptr(),
            band.data_ptr(), idx.data_ptr(), stream)
    _build.check(lib, code, "mach_candidate_topk")
    mach_candidate_topk_cuda.launches += 1
    return sel, band, idx


mach_candidate_topk_cuda.launches = 0


def mach_candidate_topk_fake(meta_probs, tau, ids, inverted, table=None, *,
                             k, **_):
    """Kernel 8's stand-in on fake tensors: sel (N, k) f32, band and idx
    (N, k) int32; nothing built or launched."""
    n = meta_probs.shape[0]
    return (meta_probs.new_empty((n, k), dtype=torch.float32),
            meta_probs.new_empty((n, k), dtype=torch.int32),
            meta_probs.new_empty((n, k), dtype=torch.int32))


def mach_candidate_topk(meta_probs: torch.Tensor, inverted: torch.Tensor,
                        table: Optional[torch.Tensor] = None, *,
                        num_classes: int, k: int, m: int, t: int = 1,
                        estimator: str = "unbiased",
                        inline_coeffs: Optional[torch.Tensor] = None,
                        inline_shift: Optional[int] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate-filtered top-k.  meta_probs (N, R, B), inverted (R·B, L)
    -> (val, idx) (N, k) on the estimator's scale; filtered slots are
    (-inf, -1).  Kernels 7 and 8 on a CUDA tensor, their plain versions
    on a CPU tensor, their stand-ins on a fake tensor."""
    check_decode_operands(meta_probs, table, num_classes, inline_coeffs,
                          inline_shift)
    n, r, b = meta_probs.shape
    validate_candidate_args(num_classes, k, m, t, r, b, estimator)
    _check_limits(num_classes, k)
    _check_inverted(inverted, r, b, meta_probs.device)
    kind = meta_probs.device.type
    if counting.is_fake(meta_probs):
        topm, fn = bucket_topm_fake, mach_candidate_topk_fake
    elif kind == "cuda":
        topm, fn = bucket_topm_cuda, mach_candidate_topk_cuda
    elif kind == "cpu":
        topm, fn = bucket_topm, mach_candidate_topk_plain
    else:
        raise ValueError(f"no decode path for device {meta_probs.device}")
    with counting.launch("bucket_topm", topm_work(n, r, b, m)):
        tau, ids = topm(meta_probs, m)
    with counting.launch("mach_candidate_topk", work(
            n, r, b, m, inverted.shape[1], k, num_classes,
            table is not None)):
        sel, band, idx = fn(meta_probs, tau, ids, inverted, table,
                            num_classes=num_classes, k=k, t=t,
                            estimator=estimator, inline_coeffs=inline_coeffs,
                            inline_shift=inline_shift)
    return finish_candidates(sel, band, idx, r, b, estimator)

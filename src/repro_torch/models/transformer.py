"""Model assembly: ModelConfig, block dispatch, stacked layers.

A model is a cycled ``block_pattern`` of block kinds, every kind of the
JAX package:

  attn        self-attention (+MLP)          — dense transformers
  attn_local  local-window self-attention    — griffin local layers
  moe         self-attention (+MoE)          — mixtral, qwen2-moe
  rglru       RG-LRU recurrent block (+MLP)  — recurrentgemma
  mlstm/slstm xLSTM blocks (no second MLP)   — xlstm-350m
  enc         non-causal self-attention      — enc-dec encoder layers
  xattn       self + cross attention (+MLP)  — enc-dec decoder layers

The cycled pattern is factored
into (pattern × n_periods) stacks whose parameters are stacked on a
leading layer axis, as in the JAX package, so its params map across
leaf for leaf; ``apply_stacks`` loops over that axis in Python.  With
``remat="full"``, gradients on and no caches (training), each step of
that loop — one period of the pattern, the JAX package's scan body — is
recomputed in the backward pass (``torch.utils.checkpoint``), so only
its input stays in memory; serving runs it as it is.  MoE blocks return
their load-balance and router-z losses, summed over layers (the
checkpointed period returns them too).  ``xattn`` blocks read the
encoder's cross-attention K/V (``cross_kv``), passed as ``enc_kvs``
mirroring the params nesting.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.manager import tree_leaves, tree_unflatten
from repro_torch.core.mach import MACHConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, moe as moe_lib, recurrent, xlstm
from repro_torch.sharding import partitioning

PORTED_KINDS = ("attn", "attn_local", "moe", "rglru", "mlstm", "slstm",
                "enc", "xattn")
AUX_KEYS = ("load_balance", "router_z")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    family: str = "dense"            # dense | moe | enc_dec | hybrid | xlstm | vlm
    head_dim: int = 0                # 0 -> d_model // num_heads
    # attention
    attention_kind: str = "full"     # full | sliding_window
    window: int = 4096               # SWA window (attention_kind=sliding_window)
    local_window: int = 2048         # window for attn_local blocks
    rope_theta: float = 10000.0
    flash_threshold: int = 2048
    chunk_q: int = 512
    chunk_k: int = 1024
    # block pattern (cycled over num_layers)
    block_pattern: tuple = ("attn",)
    # MoE
    num_experts: int = 0
    experts_top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    moe_group_size: int = 1024
    capacity_factor: float = 1.25
    lb_loss_coef: float = 0.01
    z_loss_coef: float = 1e-3
    # enc-dec
    num_encoder_layers: int = 0
    # recurrent widths
    rnn_width: int = 0               # 0 -> d_model
    mlstm_proj: float = 2.0
    # frontend stubs
    frontend: Optional[str] = None   # audio | vision
    num_prefix_tokens: int = 0
    # head
    mach: Optional[MACHConfig] = None
    mach_fused_loss: bool = False
    mach_bucket_select: Optional[tuple] = None
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    embed_scale: float = 1.0         # gemma-family: sqrt(d_model)
    # numerics / structure
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = None          # None -> float32; full configs use bf16
    remat: str = "full"              # none | full
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_rnn_width(self) -> int:
        return self.rnn_width or self.d_model

    def layout(self, n: Optional[int] = None) -> list:
        n = n or self.num_layers
        pat = self.block_pattern
        return [pat[i % len(pat)] for i in range(n)]

    def block_window(self, kind: str) -> Optional[int]:
        if kind == "attn_local":
            return self.local_window
        if kind in ("attn", "moe", "xattn") and self.attention_kind == "sliding_window":
            return self.window
        return None

    def param_count_estimate(self) -> int:
        """Analytic parameter count (the JAX package's formula)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        per = {}
        per["attn"] = d * hd * (self.num_heads * 2 + self.num_kv_heads * 2) \
            + (3 if self.activation in ("swiglu", "geglu") else 2) * d * f + 2 * d
        per["attn_local"] = per["attn"]
        per["xattn"] = per["attn"] + d * hd * (self.num_heads + self.num_kv_heads * 2) + d
        mo = self.moe_d_ff or f
        per["moe"] = d * hd * (self.num_heads * 2 + self.num_kv_heads * 2) \
            + self.num_experts * 3 * d * mo + d * self.num_experts \
            + (3 * d * self.shared_d_ff if self.num_shared_experts else 0) + 2 * d
        w = self.resolved_rnn_width
        per["rglru"] = 3 * d * w + 2 * w * w + 5 * w \
            + (3 if self.activation in ("swiglu", "geglu") else 2) * d * f + 2 * d
        di = int(d * self.mlstm_proj)
        hdm = di // self.num_heads
        per["mlstm"] = d * 2 * di + 3 * di * self.num_heads * hdm \
            + 2 * di * self.num_heads + di * d + 2 * d
        hds = d // self.num_heads
        per["slstm"] = 4 * d * d + 4 * self.num_heads * hds * hds \
            + 3 * d * int(d * 4 / 3) + 2 * d
        total = sum(per[k] for k in self.layout())
        total += per["attn"] * self.num_encoder_layers
        total += v * d                                    # embedding
        if self.mach is not None:
            total += d * self.mach.num_repetitions * self.mach.num_buckets
        elif not self.tie_embeddings:
            total += d * v
        return total


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

def init_block(generator, cfg: ModelConfig, kind: str, device) -> dict:
    if kind not in PORTED_KINDS:
        raise ValueError(kind)
    p = {"norm1": layers.init_norm(cfg.d_model, cfg.norm, device)}
    if kind == "mlstm":                           # no second MLP
        p["mlstm"] = xlstm.init_mlstm_block(generator, cfg.d_model,
                                            cfg.num_heads, cfg.mlstm_proj,
                                            device)
        return p
    if kind == "slstm":
        p["slstm"] = xlstm.init_slstm_block(generator, cfg.d_model,
                                            cfg.num_heads, device=device)
        return p
    if kind == "rglru":
        p["rglru"] = recurrent.init_rglru_block(
            generator, cfg.d_model, cfg.resolved_rnn_width, device)
    else:
        p["attn"] = attn_lib.init_attention(
            generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, device)
    if kind == "xattn":
        p["norm_x"] = layers.init_norm(cfg.d_model, cfg.norm, device)
        p["xattn"] = attn_lib.init_attention(
            generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, device)
    p["norm2"] = layers.init_norm(cfg.d_model, cfg.norm, device)
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(
            generator, cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts,
            cfg.num_shared_experts, cfg.shared_d_ff, device, cfg.activation)
    else:
        p["mlp"] = layers.init_mlp(generator, cfg.d_model, cfg.d_ff, device,
                                   cfg.activation)
    return p


def block_axes(cfg: ModelConfig, kind: str) -> dict:
    """``init_block``'s tree of logical axes (one block, unstacked)."""
    if kind not in PORTED_KINDS:
        raise ValueError(kind)
    a = {"norm1": layers.norm_axes(cfg.norm)}
    if kind == "mlstm":
        return {**a, "mlstm": xlstm.MLSTM_AXES}
    if kind == "slstm":
        return {**a, "slstm": xlstm.SLSTM_AXES}
    a["rglru" if kind == "rglru" else "attn"] = (
        recurrent.RGLRU_AXES if kind == "rglru" else attn_lib.ATTENTION_AXES)
    if kind == "xattn":
        a["norm_x"] = layers.norm_axes(cfg.norm)
        a["xattn"] = attn_lib.ATTENTION_AXES
    a["norm2"] = layers.norm_axes(cfg.norm)
    if kind == "moe":
        a["moe"] = moe_lib.moe_axes(cfg.num_shared_experts, cfg.activation)
    else:
        a["mlp"] = layers.mlp_axes(cfg.activation)
    return a


def _out_proj(params: dict, out: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) attention output @ o (H, hd, d) -> (B, T, d)."""
    o = params["o"]["kernel"].to(out.dtype)
    b, t = out.shape[:2]
    return out.reshape(b, t, -1) @ o.reshape(-1, o.shape[-1])


def _self_attention(params: dict, cfg: ModelConfig, x, positions, window,
                    cache, causal: bool = True, per_slot: bool = False,
                    kv: Optional[tuple] = None):
    """Returns (attn_out, cache); a given cache is updated in place.
    ``params`` may hold a rank's query heads of q and o (a split block);
    ``kv`` then names the heads [k0, k1) of the whole k and v it reads (a
    ``BlockSplit``'s ``kv``; None: k and v as given)."""
    q = layers.dense(params["q"], x)
    k_p, v_p = params["k"], params["v"]
    if kv is not None:
        k_p, v_p = ({"kernel": p["kernel"][:, kv[0]:kv[1]]}
                    for p in (k_p, v_p))
    k = layers.dense(k_p, x)
    v = layers.dense(v_p, x)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    if isinstance(cache, attn_lib.PagedKVCache):     # paged slot decode
        if x.shape[1] > 1:
            raise NotImplementedError(
                "paged caches decode one token per slot; prefill goes "
                "through a batch-1 contiguous cache that the engine "
                "scatters into reserved pages (chunked paged prefill is "
                "a future admission policy)")
        cache = attn_lib.paged_cache_update_decode(cache, k, v)
        out = attn_lib.paged_decode_attend(q, cache, window=window)
    elif cache is None or x.shape[1] > 1:
        if cache is not None:                 # prefill into cache
            cache = attn_lib.cache_update_prefill(cache, k, v, positions)
        out = attn_lib.attend(q, k, v, positions, positions, causal=causal,
                              window=window,
                              flash_threshold=cfg.flash_threshold,
                              chunk_q=cfg.chunk_q)
    else:                                     # single-token decode
        ring = window is not None and cache.capacity <= window
        cache = attn_lib.cache_update_decode(cache, k, v, ring,
                                             per_row=per_slot)
        out = attn_lib.decode_attend(q, cache, window=window)
    return _out_proj(params, out), cache


def _cross_attention(params: dict, cfg: ModelConfig, x, enc_kv):
    """Attention of x over precomputed encoder (k, v) (``cross_kv``):
    every query and key at position 0, non-causal, no window."""
    q = layers.dense(params["q"], x)
    k, v = enc_kv
    b, t = x.shape[:2]
    q_pos = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    k_pos = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    out = attn_lib.attend(q, k, v, q_pos, k_pos, causal=False, window=None,
                          flash_threshold=cfg.flash_threshold,
                          chunk_q=cfg.chunk_q)
    return _out_proj(params, out)


def cross_kv(params_block: dict, x_enc: torch.Tensor):
    """One ``xattn`` block's cross-attention (k, v) from the encoder
    output (B, S, d): each (B, S, KV, hd)."""
    return (layers.dense(params_block["xattn"]["k"], x_enc),
            layers.dense(params_block["xattn"]["v"], x_enc))


def apply_block(params: dict, cfg: ModelConfig, kind: str, x, positions,
                cache=None, enc_kv=None, decode: bool = False,
                per_slot: bool = False,
                split: Optional[partitioning.BlockSplit] = None):
    """Pre-norm residual block.  Returns (x, cache, aux): aux holds an MoE
    block's losses, empty for the other kinds.  ``enc_kv`` is an
    ``xattn`` block's (k, v); ``decode`` picks the xLSTM blocks' step
    form.  ``split`` (a sharded step's ``partitioning.block_split`` of
    ``params``, which then hold the rank's shards) runs the
    self-attention on the rank's query heads and the MLP on its hidden
    columns: the normed input goes into each (dh summed over the split's
    ranks in the backward) and each output comes out summed over them,
    so the residual stream stays whole; an MoE block's experts run on
    the rank's experts or columns (``moe.apply_moe(split=)``).  None (one
    device, and every cache path) runs the block whole."""
    attn_split = split.attn if split is not None else None
    mlp_split = split.mlp if split is not None else None
    h = layers.apply_norm(params["norm1"], x, cfg.norm)
    if kind == "mlstm":
        out, cache = xlstm.apply_mlstm_block(params["mlstm"], h, cache,
                                             decode=decode)
        return x + out, cache, {}
    if kind == "slstm":
        out, cache = xlstm.apply_slstm_block(params["slstm"], h, cache,
                                             decode=decode)
        return x + out, cache, {}
    if kind == "rglru":
        out, cache = recurrent.apply_rglru_block(params["rglru"], h, cache)
    elif kind in ("attn", "attn_local", "moe", "enc", "xattn"):
        if attn_split is not None:
            h = attn_split.into(h)
        out, cache = _self_attention(params["attn"], cfg, h, positions,
                                     cfg.block_window(kind), cache,
                                     causal=kind != "enc", per_slot=per_slot,
                                     kv=split.kv if attn_split else None)
        if attn_split is not None:
            out = attn_split.out_of(out)
    else:
        raise ValueError(kind)
    x = x + out
    if kind == "xattn":
        hx = layers.apply_norm(params["norm_x"], x, cfg.norm)
        x = x + _cross_attention(params["xattn"], cfg, hx, enc_kv)
    h2 = layers.apply_norm(params["norm2"], x, cfg.norm)
    if kind == "moe":
        out2, aux = moe_lib.apply_moe(
            params["moe"], h2, num_experts=cfg.num_experts,
            top_k=cfg.experts_top_k, activation=cfg.activation,
            capacity_factor=cfg.capacity_factor,
            group_size=cfg.moe_group_size,
            split=split.moe if split is not None else None)
        return x + out2, cache, aux
    if mlp_split is not None:
        h2 = mlp_split.into(h2)
    out2 = layers.apply_mlp(params["mlp"], h2, cfg.activation)
    if mlp_split is not None:
        out2 = mlp_split.out_of(out2)
    return x + out2, cache, {}


# ---------------------------------------------------------------------------
# Stacked layers over cycled patterns
# ---------------------------------------------------------------------------

def plan_stacks(layout: list) -> list:
    """Factor the layer layout into [(period_kinds, n_periods), ...]."""
    if not layout:
        return []
    pat_len = 1
    for pl in range(1, len(layout) + 1):
        if all(layout[i] == layout[i % pl] for i in range(len(layout))):
            pat_len = pl
            break
    n_full = len(layout) // pat_len
    stacks = []
    if n_full:
        stacks.append((tuple(layout[:pat_len]), n_full))
    rem = layout[n_full * pat_len:]
    if rem:
        stacks.append((tuple(rem), 1))
    return stacks


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts, lists and
    NamedTuples (the params and cache pytrees)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def init_stacks(generator, cfg: ModelConfig, layout: list, device) -> list:
    """List over stacks of lists over period positions of block params
    stacked on a leading layer axis.  Each block's float leaves take
    ``cfg.param_dtype`` (if set) as the block is drawn, and the block is
    copied into its preallocated stack, so drawing holds the stacks and
    one float32 block (a 20 B-parameter model's float32 blocks would not
    fit beside its bf16 stacks on one card)."""
    def cast(x):
        if cfg.param_dtype is not None and x.is_floating_point():
            return x.to(cfg.param_dtype)
        return x

    params = []
    for period, n in plan_stacks(layout):
        p_list = []
        for kind in period:
            stacked = None
            for li in range(n):
                block = tree_map(cast, init_block(generator, cfg, kind, device))
                if stacked is None:
                    stacked = tree_map(lambda x: x.new_empty((n,) + x.shape),
                                       block)
                tree_map(lambda st, x: st[li].copy_(x), stacked, block)
            p_list.append(stacked)
        params.append(p_list)
    return params


def stacks_axes(cfg: ModelConfig, layout: list) -> list:
    """``init_stacks``'s tree of logical axes: each block's with the
    stacked ``layers`` dim first."""
    def stacked(a):
        if isinstance(a, dict):
            return {k: stacked(v) for k, v in a.items()}
        return ("layers",) + a

    return [[stacked(block_axes(cfg, kind)) for kind in period]
            for period, _ in plan_stacks(layout)]


def unstack(tree, n: int) -> list:
    """A tree of leaves stacked on a leading axis of ``n`` as ``n`` trees
    of their slices: one ``unbind`` a leaf, whose backward is one
    ``stack`` (``n`` selects would each add a zero-filled copy of the
    whole stack to its gradient)."""
    leaves = [x.unbind(0) for x in tree_leaves(tree)]
    return [tree_unflatten(tree, [u[i] for u in leaves]) for i in range(n)]


def _add_aux(total: dict, aux: dict) -> dict:
    return {k: v + aux.get(k, 0.0) for k, v in total.items()}


def _kept_parts(block: dict, split) -> dict:
    """The parts of one block's params that its split computes on the
    rank's ranges: each part's path (a tuple of keys) -> the split's
    mesh dims, which its gather keeps."""
    if split is None:
        return {}
    parts = {(key,): s.dims for key, s in (("attn", split.attn),
                                           ("mlp", split.mlp)) if s}
    if split.moe is not None:
        routed, shared = split.moe.routed, split.moe.shared
        if routed is not None:
            parts.update({("moe", key): routed.dims
                          for key in ("wi", "wg", "wo")
                          if key in block["moe"]})
        if shared is not None:
            parts[("moe", "shared")] = shared.dims
    return parts


def _pick(tree: dict, paths, keep: bool) -> dict:
    """``tree`` with only (``keep``) or without the subtrees at
    ``paths``."""
    heads = {p[0] for p in paths}
    out = {}
    for key, value in tree.items():
        if (key,) in paths:
            if keep:
                out[key] = value
        elif key in heads:
            sub = _pick(value, [p[1:] for p in paths if p[0] == key], keep)
            if sub:
                out[key] = sub
        elif not keep:
            out[key] = value
    return out


def _merge(dst: dict, src: dict) -> None:
    for key, value in src.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            _merge(dst[key], value)
        else:
            dst[key] = value


def materialize_period(layer_params: list, splits: list) -> list:
    """One period's params for its use here, each block by its split
    (``partitioning.block_split``, None on one device): a split
    attention's q, k, v and o, a split MLP's wi, wg and wo and a split
    MoE block's expert kernels (and its shared MLP's) are gathered
    keeping the split's mesh dims (``materialize(keep=)``; a k or v
    replicated there has its gradient summed there), every other leaf
    whole (``partitioning.materialize``), the router and ``shared_gate``
    too: their gradient is one device's on every rank (the gates go into
    the split), so it is summed over the batch axes only.  One gather
    for the leaves gathered whole and one for each split's mesh dims."""
    parts = [_kept_parts(lp, split) for lp, split in zip(layer_params, splits)]
    if not any(parts):
        return partitioning.materialize(layer_params)
    out = partitioning.materialize([_pick(lp, list(part), keep=False)
                                    for lp, part in zip(layer_params, parts)])
    for dims in sorted({d for part in parts for d in part.values()}):
        kept = partitioning.materialize([
            _pick(lp, [p for p, d in part.items() if d == dims], keep=True)
            for lp, part in zip(layer_params, parts)], keep=dims)
        for block, kept_block in zip(out, kept):
            _merge(block, kept_block)
    return out


def _apply_period(layer_params: list, cfg: ModelConfig, period: tuple, x,
                  positions, layer_enc: Optional[list], splits: list):
    """One period of the pattern without caches (the remat unit), its
    params gathered here (``materialize_period``), so a recompute
    gathers them again, and the split blocks' sums over their ranks run
    again too: every rank recomputes the same periods in the same order,
    so their collectives match.  Returns (x, the period's aux sums)."""
    layer_params = materialize_period(layer_params, splits)
    aux = dict.fromkeys(AUX_KEYS, 0.0)
    for pi, (lp, kind) in enumerate(zip(layer_params, period)):
        ek = layer_enc[pi] if layer_enc is not None else None
        x, _, block_aux = apply_block(lp, cfg, kind, x, positions, enc_kv=ek,
                                      split=splits[pi])
        aux = _add_aux(aux, block_aux)
    return x, aux


def apply_stacks(params: list, cfg: ModelConfig, layout: list, x, positions,
                 caches: Optional[list] = None, enc_kvs: Optional[list] = None,
                 decode: bool = False, per_slot: bool = False):
    """Run every layer in order; ``caches`` and ``enc_kvs`` (each ``xattn``
    block's stacked (k, v)) mirror the params nesting, and caches are
    updated in place.  Returns (x, caches, aux): the MoE blocks'
    ``load_balance`` and ``router_z`` summed over layers (0.0 without
    MoE blocks).

    Each period's slices of the stacked params (``unstack``; under FSDP
    ``DTensor``s, each the slice of a shard along the replicated layer
    dim, with no communication) are gathered whole where the period
    runs.  Under remat the forward gathers a period, uses it and drops
    it, and the backward's recompute gathers it again: a rank holds
    about one period whole.  With caches (serving) or ``remat="none"`` the same gather
    runs, and autograd keeps what the period's backward needs of the
    gathered weights until then (every period's, when gradients are
    on).  Where a block's attention, MLP or experts split on the
    ``model`` mesh axis (``partitioning.block_split``), the rank gathers
    and computes only its heads, columns or experts
    (``apply_block(split=)``).  A cache path
    never splits: ``DTensor`` params are read only inside a train step
    (``materialize`` raises elsewhere), and served params are whole."""
    remat = cfg.remat == "full" and caches is None and torch.is_grad_enabled()
    aux = dict.fromkeys(AUX_KEYS, 0.0)
    for si, ((period, n), p_list) in enumerate(zip(plan_stacks(layout), params)):
        slices = unstack(p_list, n)
        # every period of a stack has its leaves' placements and shapes
        splits = [partitioning.block_split(lp) for lp in slices[0]]
        for li in range(n):
            layer_params = slices[li]
            layer_enc = ([tree_map(lambda v: v[li], e) for e in enc_kvs[si]]
                         if enc_kvs is not None else None)
            if remat:
                x, period_aux = checkpoint(_apply_period, layer_params, cfg,
                                           period, x, positions, layer_enc,
                                           splits, use_reentrant=False)
                aux = _add_aux(aux, period_aux)
                continue
            layer_params = materialize_period(layer_params, splits)
            for pi, kind in enumerate(period):
                lc = (tree_map(lambda v: v[li], caches[si][pi])
                      if caches is not None else None)
                ek = layer_enc[pi] if layer_enc is not None else None
                x, _, block_aux = apply_block(layer_params[pi], cfg, kind, x,
                                              positions, lc, ek, decode,
                                              per_slot, splits[pi])
                aux = _add_aux(aux, block_aux)
    return x, caches, aux

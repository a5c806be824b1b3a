"""Model assembly: ModelConfig, block dispatch, stacked layers.

A model is a cycled ``block_pattern`` of block kinds.  The port has:

  attn        self-attention (+MLP)          — dense transformers
  attn_local  local-window self-attention    — griffin local layers
  moe         self-attention (+MoE)          — mixtral, qwen2-moe
  rglru       RG-LRU recurrent block (+MLP)  — recurrentgemma

``xattn``, ``enc``, ``mlstm`` and ``slstm`` raise ``NotImplementedError``
(ROADMAP.md).  The cycled pattern is factored
into (pattern × n_periods) stacks whose parameters are stacked on a
leading layer axis, as in the JAX package, so its params map across
leaf for leaf; ``apply_stacks`` loops over that axis in Python.  With
``remat="full"``, gradients on and no caches (training), each step of
that loop — one period of the pattern, the JAX package's scan body — is
recomputed in the backward pass (``torch.utils.checkpoint``), so only
its input stays in memory; serving runs it as it is.  MoE blocks return
their load-balance and router-z losses, summed over layers (the
checkpointed period returns them too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.mach import MACHConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, moe as moe_lib, recurrent

PORTED_KINDS = ("attn", "attn_local", "moe", "rglru")
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


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet, for serving or "
            f"training; the port has {PORTED_KINDS} (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

def init_block(generator, cfg: ModelConfig, kind: str, device) -> dict:
    _check_kind(kind)
    p = {"norm1": layers.init_norm(cfg.d_model, cfg.norm, device)}
    if kind == "rglru":
        p["rglru"] = recurrent.init_rglru_block(
            generator, cfg.d_model, cfg.resolved_rnn_width, device)
    else:
        p["attn"] = attn_lib.init_attention(
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


def _self_attention(params: dict, cfg: ModelConfig, x, positions, window,
                    cache, per_slot: bool = False):
    """Returns (attn_out, cache); a given cache is updated in place."""
    q = layers.dense(params["q"], x)
    k = layers.dense(params["k"], x)
    v = layers.dense(params["v"], x)
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
        out = attn_lib.attend(q, k, v, positions, positions, causal=True,
                              window=window,
                              flash_threshold=cfg.flash_threshold,
                              chunk_q=cfg.chunk_q)
    else:                                     # single-token decode
        ring = window is not None and cache.capacity <= window
        cache = attn_lib.cache_update_decode(cache, k, v, ring,
                                             per_row=per_slot)
        out = attn_lib.decode_attend(q, cache, window=window)
    o = params["o"]["kernel"].to(out.dtype)
    b, t = out.shape[:2]
    return out.reshape(b, t, -1) @ o.reshape(-1, o.shape[-1]), cache


def apply_block(params: dict, cfg: ModelConfig, kind: str, x, positions,
                cache=None, per_slot: bool = False):
    """Pre-norm residual block.  Returns (x, cache, aux): aux holds an MoE
    block's losses, empty for the other kinds."""
    _check_kind(kind)
    h = layers.apply_norm(params["norm1"], x, cfg.norm)
    if kind == "rglru":
        out, cache = recurrent.apply_rglru_block(params["rglru"], h, cache)
    else:
        out, cache = _self_attention(params["attn"], cfg, h, positions,
                                     cfg.block_window(kind), cache,
                                     per_slot=per_slot)
    x = x + out
    h2 = layers.apply_norm(params["norm2"], x, cfg.norm)
    if kind == "moe":
        out2, aux = moe_lib.apply_moe(
            params["moe"], h2, num_experts=cfg.num_experts,
            top_k=cfg.experts_top_k, activation=cfg.activation,
            capacity_factor=cfg.capacity_factor,
            group_size=cfg.moe_group_size)
        return x + out2, cache, aux
    return x + layers.apply_mlp(params["mlp"], h2, cfg.activation), cache, {}


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


def _add_aux(total: dict, aux: dict) -> dict:
    return {k: v + aux.get(k, 0.0) for k, v in total.items()}


def _apply_period(layer_params: list, cfg: ModelConfig, period: tuple, x,
                  positions):
    """One period of the pattern without caches (the remat unit).
    Returns (x, the period's aux sums)."""
    aux = dict.fromkeys(AUX_KEYS, 0.0)
    for lp, kind in zip(layer_params, period):
        x, _, block_aux = apply_block(lp, cfg, kind, x, positions)
        aux = _add_aux(aux, block_aux)
    return x, aux


def apply_stacks(params: list, cfg: ModelConfig, layout: list, x, positions,
                 caches: Optional[list] = None, per_slot: bool = False):
    """Run every layer in order; ``caches`` mirror the params nesting and
    are updated in place.  Returns (x, caches, aux): the MoE blocks'
    ``load_balance`` and ``router_z`` summed over layers (0.0 without
    MoE blocks)."""
    remat = cfg.remat == "full" and caches is None and torch.is_grad_enabled()
    aux = dict.fromkeys(AUX_KEYS, 0.0)
    for si, ((period, n), p_list) in enumerate(zip(plan_stacks(layout), params)):
        for li in range(n):
            layer_params = [tree_map(lambda v: v[li], p) for p in p_list]
            if remat:
                x, period_aux = checkpoint(_apply_period, layer_params, cfg,
                                           period, x, positions,
                                           use_reentrant=False)
                aux = _add_aux(aux, period_aux)
                continue
            for pi, kind in enumerate(period):
                lc = (tree_map(lambda v: v[li], caches[si][pi])
                      if caches is not None else None)
                x, _, block_aux = apply_block(layer_params[pi], cfg, kind, x,
                                              positions, lc, per_slot)
                aux = _add_aux(aux, block_aux)
    return x, caches, aux

"""LanguageModel: embeddings → (encoder) → stacked decoder layers → head.

The port of ``repro/models/model.py``.  The config decides the block
pattern, the encoder (enc-dec: every decoder layer an ``xattn`` block
over the encoder's output), the vision prefix (``frontend="vision"``:
adapted patch features before the text tokens) and the head: the MACH
head (the paper's) or the dense OAA softmax (``cfg.mach is None``; tied
to the embeddings or its own ``lm_head``).  MoE blocks add their
load-balance and router-z losses to the training loss.

Every read of a param goes through ``partitioning.materialize``, the
identity on plain tensors; under FSDP (a sharded train step's
``DTensor`` params) it gathers the leaf whole at its use and the
backward reduce-scatters its gradient (``apply_stacks`` does so a layer
period at a time).  Where the ``model`` mesh axis splits them, a rank
keeps its shard of the MACH head (its repetitions) and of each decoder
block's attention and MLP (its query heads and hidden columns), computes
those alone and sums the partial results over the split's ranks
(``partitioning.head_split``, ``partitioning.block_split``).

Public surface:
  init(generator, device)                      -> params
  param_axes()                                 -> the params' logical axes
  loss(params, batch)                          -> (loss, metrics): the
      R-head CE on the head's logits (kernel 3), or with
      ``mach_fused_loss`` the fused logit-free loss (kernel 4, over the
      selected buckets with ``mach_bucket_select``); OAA: softmax CE;
      plus the MoE aux losses.  ``enc_feats`` run the encoder; after
      ``prefix_feats`` only the text positions are predicted
  encode(params, enc_feats)                    -> encoder output
  enc_kvs(params, enc_out)                     -> cross-attention K/V
  hidden_states(params, tokens, caches=...)    -> (hidden, caches, aux)
  prefill(params, tokens, max_len, enc_kvs=, prefix_feats=)
                                               -> (caches, last_hidden)
  decode_step(params, caches, tokens, pos, enc_kvs=) -> (caches, hidden)
  next_token / topk_scores / topk_candidates   -> MACH decode (kernels 1-2,
      or 7-8 with candidate_mode); OAA: argmax / top-k of the logits

Caches are nested lists of ``KVCache`` / ``RecurrentState`` /
``MLSTMState`` / ``SLSTMState`` with a leading stacked-layer axis and
the batch (slot) axis second, as in the JAX package; prefill and decode
write into them in place.  ``enc_kvs`` mirror the decoder's params
nesting: each ``xattn`` position holds (k, v), each (layers, B, S, KV,
hd).  A paged pool
(``init_paged_caches``) holds ``PagedKVCache`` leaves in place of the
linear attention caches; its slot ops (``insert_cache_slot_paged``,
``reset_cache_slot_paged``, ``append_cache_page``) touch each leaf kind
as the JAX package's do.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.hashing import MultShiftFamily
from repro_torch.core.mach import MACHOutputHead
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_lib
from repro_torch.models import frontends, layers, recurrent, xlstm
from repro_torch.models.transformer import (ModelConfig, apply_stacks,
                                            cross_kv, init_stacks,
                                            plan_stacks, stacks_axes,
                                            tree_map, unstack)
from repro_torch.sharding import partitioning


class LanguageModel:

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.head = (MACHOutputHead(cfg.mach, cfg.d_model, torch.float32)
                     if cfg.mach is not None else None)
        self._coeffs: dict = {}

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        """Random params drawn from ``generator`` (a CUDA generator draws
        on the card); float leaves cast to ``cfg.param_dtype`` if set."""
        cfg = self.cfg
        device = resolve_device(device)
        p = {"embed": layers.init_embedding(generator, cfg.vocab_size,
                                            cfg.d_model, device),
             "stacks": init_stacks(generator, cfg, self._dec_layout(), device),
             "final_norm": layers.init_norm(cfg.d_model, cfg.norm, device)}
        if cfg.mach is not None:
            p["mach_head"] = self.head.init(generator, device)
        elif not cfg.tie_embeddings:
            p["lm_head"] = layers.init_dense(generator, cfg.d_model,
                                             (cfg.vocab_size,), device)
        if cfg.num_encoder_layers:
            p["enc_adapter"] = frontends.init_adapter(
                generator, frontends.frontend_feature_dim(
                    cfg.frontend or "audio"), cfg.d_model, device)
            p["enc_stacks"] = init_stacks(
                generator, cfg, ["enc"] * cfg.num_encoder_layers, device)
            p["enc_norm"] = layers.init_norm(cfg.d_model, cfg.norm, device)
        if cfg.frontend == "vision":
            p["vis_adapter"] = frontends.init_adapter(
                generator, frontends.VISION_FEATURE_DIM, cfg.d_model, device)
        if cfg.param_dtype is not None:
            p = tree_map(lambda x: x.to(cfg.param_dtype)
                         if x.is_floating_point() else x, p)
        return p

    def param_axes(self) -> dict:
        """``init``'s tree with a tuple of logical axis names (one a dim)
        in place of each tensor — the JAX package's ``init``'s second
        result, read by ``sharding.params_shardings``."""
        cfg = self.cfg
        a = {"embed": layers.EMBEDDING_AXES,
             "stacks": stacks_axes(cfg, self._dec_layout()),
             "final_norm": layers.norm_axes(cfg.norm)}
        if cfg.mach is not None:
            a["mach_head"] = {"kernel": ("embed", "mach_rb")}
        elif not cfg.tie_embeddings:
            a["lm_head"] = layers.dense_axes("embed", ("vocab",))
        if cfg.num_encoder_layers:
            a["enc_adapter"] = frontends.ADAPTER_AXES
            a["enc_stacks"] = stacks_axes(cfg,
                                          ["enc"] * cfg.num_encoder_layers)
            a["enc_norm"] = layers.norm_axes(cfg.norm)
        if cfg.frontend == "vision":
            a["vis_adapter"] = frontends.ADAPTER_AXES
        return copy.deepcopy(a)         # the modules' constants stay theirs

    def _dec_layout(self) -> list:
        """The decoder's layer kinds: every layer ``xattn`` with an encoder,
        else the config's cycled pattern."""
        cfg = self.cfg
        if cfg.num_encoder_layers:
            return ["xattn"] * cfg.num_layers
        return cfg.layout()

    # --------------------------------------------------------------- forward
    def _embed_tokens(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = layers.embed(partitioning.materialize(params["embed"]), tokens,
                         cfg.dtype)
        if cfg.embed_scale != 1.0:
            # the scale is rounded to the compute dtype, as in the JAX package
            x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype,
                                 device=x.device)
        return x

    def encode(self, params: dict, enc_feats: torch.Tensor) -> torch.Tensor:
        """Frontend features (B, S, F) -> encoder output (B, S, d): the
        adapter, the non-causal ``enc`` layers at positions 0..S-1, the
        encoder's final norm."""
        cfg = self.cfg
        x = frontends.apply_adapter(
            partitioning.materialize(params["enc_adapter"]), enc_feats,
            cfg.dtype)
        b, s = x.shape[:2]
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        x, _, _ = apply_stacks(params["enc_stacks"], cfg,
                               ["enc"] * cfg.num_encoder_layers, x, pos)
        return layers.apply_norm(partitioning.materialize(params["enc_norm"]),
                                 x, cfg.norm)

    def enc_kvs(self, params: dict, enc_out: torch.Tensor) -> list:
        """Every decoder layer's cross-attention (k, v) from the encoder
        output, stacked on the layer axis like the params: a loop over
        that axis where the JAX package ``vmap``s ``cross_kv``.  Each
        layer's k / v weights are gathered at their use; autograd keeps
        them to the backward (as the ``vmap`` holds every layer's).
        Where a sharded step splits the cross-attention by heads
        (``partitioning.block_split``'s ``xattn``), the rank gathers k and
        v keeping the split's mesh dims and computes only its kv heads
        (cut by ``xkv`` from a whole k and v): the encoder output goes
        into the split once for every layer, so the backward sums its
        gradient over the split's ranks once."""
        out, into = [], {}
        for p_list in params["stacks"]:
            st = []
            for pp in p_list:
                n = pp["xattn"]["k"]["kernel"].shape[0]
                slices = unstack({"xattn": pp["xattn"]}, n)
                split = partitioning.block_split(slices[0])
                xs = split.xattn if split is not None else None
                if xs is None:
                    kvs = [cross_kv({"xattn": partitioning.materialize(
                        {w: layer["xattn"][w] for w in ("k", "v")})},
                        enc_out) for layer in slices]
                else:
                    if xs.dims not in into:
                        into[xs.dims] = xs.into(enc_out)
                    kvs = [cross_kv({"xattn": partitioning.materialize(
                        {w: layer["xattn"][w] for w in ("k", "v")},
                        keep=xs.dims)}, into[xs.dims], split.xkv)
                        for layer in slices]
                st.append(tuple(torch.stack(x) for x in zip(*kvs)))
            out.append(st)
        return out

    def hidden_states(self, params: dict, tokens: torch.Tensor, *,
                      prefix_emb: Optional[torch.Tensor] = None,
                      enc_kvs: Optional[list] = None,
                      caches: Optional[list] = None,
                      positions: Optional[torch.Tensor] = None,
                      decode: bool = False, per_slot: bool = False):
        """tokens (B, T) -> (hidden (B, T(+P), d), caches, aux): aux holds
        the MoE blocks' ``load_balance`` and ``router_z`` summed over
        layers.  ``prefix_emb`` (B, P, F), the vision frontend's features,
        go through the adapter ahead of the tokens; ``enc_kvs`` feed the
        ``xattn`` blocks; ``decode`` runs the xLSTM blocks' step form."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        if prefix_emb is not None:
            pe = frontends.apply_adapter(
                partitioning.materialize(params["vis_adapter"]), prefix_emb,
                cfg.dtype)
            x = torch.cat([pe, x], dim=1)
        b, t = x.shape[:2]
        if positions is None:
            positions = torch.arange(t, dtype=torch.int32,
                                     device=x.device).expand(b, t)
        x, caches, aux = apply_stacks(params["stacks"], cfg, self._dec_layout(),
                                      x, positions, caches, enc_kvs, decode,
                                      per_slot)
        final_norm = partitioning.materialize(params["final_norm"])
        return layers.apply_norm(final_norm, x, cfg.norm), caches, aux

    def oaa_logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """The dense head's (..., V) logits in h's dtype: the tied
        embedding or ``lm_head``, then the optional tanh soft cap."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = layers.unembed(partitioning.materialize(params["embed"]),
                                    h)
        else:
            logits = layers.dense(partitioning.materialize(params["lm_head"]),
                                  h)
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def mach_logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        return self.head.apply(partitioning.materialize(params["mach_head"]),
                               h)                             # (..., R, B)

    # ------------------------------------------------------------------ loss
    def loss(self, params: dict, batch: dict):
        """batch: tokens (B, L+1) int; optional weights (B, L) and, with
        ``mach_bucket_select``, cached (R, B) ``bucket_proxy`` scores.
        Returns (total, metrics): the weighted mean over tokens of each
        next token's cross-entropy, in ``metrics["loss"]`` with
        ``"tokens"``; with MoE blocks (``cfg.num_experts``) the total adds
        ``lb_loss_coef`` x ``load_balance`` + ``z_loss_coef`` x
        ``router_z`` and the metrics gain both.

        MACH head: the summed R-head CE of the hashed label, through
        ``ops.mach_xent`` (kernel 3) on the head's logits, which take the
        activations' dtype; with ``mach_fused_loss``, through
        ``ops.mach_fused_xent`` (kernel 4), so the (B, L, R·B) logits
        never exist, over the ``mach_bucket_select`` selection if set
        (ignored otherwise, as in the JAX package).  Under a sharded
        step each rank computes the repetitions its shard of the head
        holds, where they are whole (``_mach_per_token``).  The fused op reads
        h and the head kernel in float32 whatever their dtypes, so where
        they differ both are promoted to the wider one (bf16 to float32
        is exact).  OAA head: the softmax CE of float32 logits, the
        label's logit picked by a gather.

        ``enc_feats`` (B, S, F) run the encoder, whose cross-attention K/V
        feed every decoder layer; after ``prefix_feats`` (B, P, F) the
        loss predicts the text positions only."""
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones(labels.shape, dtype=torch.float32,
                                 device=tokens.device)
        enc_kvs = None
        if cfg.num_encoder_layers:
            enc_kvs = self.enc_kvs(params, self.encode(params,
                                                       batch["enc_feats"]))
        prefix = batch.get("prefix_feats")
        h, _, aux = self.hidden_states(params, inputs, prefix_emb=prefix,
                                       enc_kvs=enc_kvs)
        if prefix is not None:
            h = h[:, prefix.shape[1]:]                   # predict text only
        if cfg.mach is None:
            logits = self.oaa_logits(params, h).to(torch.float32)
            picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
            per_tok = torch.logsumexp(logits, dim=-1) - picked
        else:
            per_tok = self._mach_per_token(params, h, labels,
                                           batch.get("bucket_proxy"))
        total = torch.sum(weights)
        loss = torch.sum(per_tok * weights) / torch.clamp(total, min=1.0)
        metrics = {"loss": loss, "tokens": total}
        if cfg.num_experts:
            metrics.update(aux)
            loss = loss + cfg.lb_loss_coef * aux["load_balance"] \
                + cfg.z_loss_coef * aux["router_z"]
        return loss, metrics

    def _mach_per_token(self, params: dict, h: torch.Tensor,
                        labels: torch.Tensor,
                        bucket_proxy: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, L) float32: each next token's summed R-head CE (kernel 3 on
        the logits, or kernel 4 fused).  Under a sharded step whose head
        splits by repetition (``partitioning.head_split``) the rank
        gathers the head over every mesh axis but those that split its
        columns, computes its own repetitions on the rows going into the
        head, and the per-token partial sums come out of the head summed
        over the ranks of the other repetitions; the selection
        (``mach_bucket_select``) is then the global batch's
        (``ops.mach_fused_xent(split=)``).  Elsewhere under a mesh the
        head is gathered whole; on one device nothing moves."""
        cfg = self.cfg
        split = partitioning.head_split(params["mach_head"]["kernel"],
                                        cfg.mach.num_repetitions)
        reps = None
        if split is None:
            head = partitioning.materialize(params["mach_head"])
        else:
            head = partitioning.materialize(params["mach_head"],
                                            keep=split.dims)
            h, labels = split.into(h), split.gather_rows(labels)
            reps = (split.r0, split.r1)
        hashed = cfg.mach.hash_labels(labels)                  # (R, B, L)
        if reps is not None:
            hashed = hashed[reps[0]:reps[1]]
        hashed = hashed.movedim(0, -1)                         # (B, L, R)
        if cfg.mach_fused_loss:
            kernel = head["kernel"]
            dt = torch.promote_types(h.dtype, kernel.dtype)
            per_tok = ops.mach_fused_xent(
                h.to(dt), kernel.to(dt), hashed,
                num_buckets=cfg.mach.num_buckets,
                bucket_select=cfg.mach_bucket_select,
                bucket_proxy=bucket_proxy, split=split)
        else:
            per_tok = ops.mach_xent(self.head.apply(head, h, reps), hashed)
        return per_tok if split is None else split.out_of(per_tok)

    # --------------------------------------------------------------- serving
    def _init_kind_cache(self, kind: str, n: int, batch: int, max_len: int,
                         device, linear_cap: Optional[int] = None,
                         paged: Optional[tuple] = None):
        """Stacked (n, ...) cache for one period position.  ``paged`` =
        (num_pages, page_size, max_pages) turns a linear attention cache
        into a page pool (``batch`` is then the slot count); ring caches
        (window < max_len) keep their strips.  ``linear_cap`` overrides
        the capacity of linear caches (the paged engine's prefill)."""
        cfg = self.cfg
        if kind == "rglru":
            one = recurrent.init_recurrent_state(
                batch, cfg.resolved_rnn_width, cfg.dtype, device)
        elif kind == "mlstm":
            di = int(cfg.d_model * cfg.mlstm_proj)
            one = xlstm.init_mlstm_state(batch, cfg.num_heads,
                                         di // cfg.num_heads, device)
        elif kind == "slstm":
            one = xlstm.init_slstm_state(batch, cfg.num_heads,
                                         cfg.d_model // cfg.num_heads, device)
        else:
            window = cfg.block_window(kind)
            ring = window is not None and window < max_len
            kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
            if paged is not None and not ring:
                num_pages, page_size, max_pages = paged
                one = attn_lib.init_paged_cache(batch, num_pages, page_size,
                                                max_pages, kv, hd, cfg.dtype,
                                                device)
            else:
                if ring:
                    cap = window
                else:
                    cap = linear_cap if linear_cap else max_len
                    if window is not None:
                        cap = min(cap, window)
                one = attn_lib.init_cache(batch, cap, kv, hd, cfg.dtype,
                                          device)
        return tree_map(lambda x: x[None].repeat((n,) + (1,) * x.dim()), one)

    def init_caches(self, batch_size: int, max_len: int,
                    linear_cap: Optional[int] = None, device=None) -> list:
        """Decode caches mirroring the stack nesting.  Local-attention
        layers whose window is below ``max_len`` get a ring of ``window``
        rows; ``linear_cap`` overrides the capacity of linear caches."""
        device = resolve_device(device)
        return [[self._init_kind_cache(kind, n, batch_size, max_len, device,
                                       linear_cap=linear_cap)
                 for kind in period]
                for period, n in plan_stacks(self._dec_layout())]

    def init_paged_caches(self, num_slots: int, max_len: int, page_size: int,
                          num_pages: int, device=None) -> list:
        """Paged decode pool: linear attention caches become one shared
        (num_pages, page_size, KV, hd) page pool per layer (plus the spare
        page, see ``PagedKVCache``) with per-slot page tables; ring caches
        and recurrent states stay per-slot strips."""
        device = resolve_device(device)
        paged = (num_pages, page_size, -(-max_len // page_size))
        return [[self._init_kind_cache(kind, n, num_slots, max_len, device,
                                       paged=paged)
                 for kind in period]
                for period, n in plan_stacks(self._dec_layout())]

    def prefill(self, params: dict, tokens: torch.Tensor, max_len: int,
                linear_cap: Optional[int] = None, *,
                enc_kvs: Optional[list] = None,
                prefix_feats: Optional[torch.Tensor] = None):
        """Process the prompt tokens (B, T), after the vision prefix
        ``prefix_feats`` (B, P, F) if given and over the encoder's
        ``enc_kvs`` (``enc_kvs(params, encode(params, enc_feats))``) for an
        enc-dec model; returns (caches, last hidden (B, d))."""
        caches = self.init_caches(tokens.shape[0], max_len, linear_cap,
                                  device=tokens.device)
        h, caches, _ = self.hidden_states(params, tokens,
                                          prefix_emb=prefix_feats,
                                          enc_kvs=enc_kvs, caches=caches)
        return caches, h[:, -1]

    def decode_step(self, params: dict, caches: list, tokens: torch.Tensor,
                    pos: torch.Tensor, per_slot: bool = False, *,
                    enc_kvs: Optional[list] = None):
        """One token step.  tokens (B,), pos (B,) absolute positions (the
        vision prefix counted); ``enc_kvs`` the rows' cross-attention K/V.
        Returns (caches, hidden (B, d)).  ``per_slot=True`` writes each
        row's KV at its own cache index (continuous batching); the
        default writes every row at row 0's index (lockstep)."""
        h, caches, _ = self.hidden_states(params, tokens[:, None],
                                          enc_kvs=enc_kvs, caches=caches,
                                          positions=pos[:, None],
                                          decode=True, per_slot=per_slot)
        return caches, h[:, 0]

    @staticmethod
    def insert_cache_slot(pool: list, one: list, slot: int) -> list:
        """Copy a batch-1 cache pytree into row ``slot`` of a pooled one
        (batch axis 1 on every leaf), in place."""
        def put(p, o):
            p[:, slot] = o[:, 0]
        tree_map(put, pool, one)
        return pool

    def reset_cache_slot(self, pool: list, slot: int, max_len: int) -> list:
        """Restore row ``slot`` of ``pool`` to the freshly initialized
        state (empty positions, zero indices and recurrent state)."""
        device = pool[0][0][0].device
        return self.insert_cache_slot(
            pool, self.init_caches(1, max_len, device=device), slot)

    # ------------------------------------------------------ paged slot pool
    @staticmethod
    def insert_cache_slot_paged(pool: list, one: list, slot: int,
                                pages: torch.Tensor) -> list:
        """Admit a batch-1 prefill cache into slot ``slot`` of a paged
        pool, in place: linear attention leaves copy their page-rounded
        strips into the pool pages ``pages`` (one id a prompt page, the
        same on every layer) and set the slot's table row; ring and
        recurrent leaves take the contiguous per-slot copy."""
        for p_st, o_st in zip(pool, one):
            for pc, oc in zip(p_st, o_st):
                if isinstance(pc, attn_lib.PagedKVCache):
                    attn_lib.paged_insert_prefill(pc, oc, slot, pages)
                else:
                    LanguageModel.insert_cache_slot(pc, oc, slot)
        return pool

    def reset_cache_slot_paged(self, pool: list, slot: int,
                               max_len: int) -> list:
        """Free slot ``slot`` of a paged pool, in place: table row → −1
        and index → 0 on paged leaves (page contents stay stale, see
        ``paged_reset_slot``); ring and recurrent leaves are restored to
        their freshly initialized state."""
        fresh = None
        for si, p_st in enumerate(pool):
            for pi, pc in enumerate(p_st):
                if isinstance(pc, attn_lib.PagedKVCache):
                    attn_lib.paged_reset_slot(pc, slot)
                    continue
                if fresh is None:
                    fresh = self.init_caches(1, max_len, device=pc[0].device)
                self.insert_cache_slot(pc, fresh[si][pi], slot)
        return pool

    @staticmethod
    def append_cache_page(pool: list, slot: int, page_idx: int,
                          page_id: int) -> list:
        """Grow ``slot``'s page table by pool page ``page_id`` at table
        position ``page_idx`` on every paged leaf and layer, in place
        (decode boundary crossing)."""
        for p_st in pool:
            for pc in p_st:
                if isinstance(pc, attn_lib.PagedKVCache):
                    attn_lib.paged_append_page(pc, slot, page_idx, page_id)
        return pool

    # ------------------------------------------------------------ MACH decode
    def _hash_kw(self, device) -> dict:
        """The decode kernels' hash source: inline multiply-shift
        coefficients, else the (R, K) table."""
        fam = self.cfg.mach.family
        if not isinstance(fam, MultShiftFamily):
            return {"table": self.head.table(device)}
        device = torch.device(device)
        if device not in self._coeffs:
            self._coeffs[device] = fam.coeffs_tensor(device)
        return {"inline_coeffs": self._coeffs[device],
                "inline_shift": fam.shift}

    def _meta_probs(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.mach_logits(params, hidden).to(torch.float32),
                             dim=-1)                          # (B, R, Bk)

    def next_token(self, params: dict, hidden: torch.Tensor):
        """Greedy next token from final hidden states (B, d) -> (ids (B,),
        values (B,)): the top-1 kernel for the unbiased estimator, the
        k=1 streaming top-k for min / median.  OAA: the argmax of the
        logits (ties to the lowest id) and its logit."""
        cfg = self.cfg
        if cfg.mach is None:
            logits = self.oaa_logits(params, hidden)
            idx = torch.argmax(logits, dim=-1)
            return idx.to(torch.int32), torch.amax(logits, dim=-1)
        if cfg.mach.estimator != "unbiased":
            vals, idxs = self.topk_scores(params, hidden, 1)
            return idxs[:, 0], vals[:, 0]
        val, idx = ops.mach_top1(self._meta_probs(params, hidden),
                                 num_classes=cfg.vocab_size,
                                 **self._hash_kw(hidden.device))
        return idx, val

    def mach_inverted_table(self, device) -> torch.Tensor:
        """The (R·B, L) inverted bucket->class table on ``device``, built
        once (candidate-filtered decode)."""
        return self.head.inverted_table(device)

    def topk_scores(self, params: dict, hidden: torch.Tensor, k: int,
                    estimator: Optional[str] = None, candidate_mode=None):
        """Top-k (values, class ids) from final hidden states (B, d) on
        the estimator's scale, through the streaming top-k kernel (no
        (B, V) scores), or the count-min candidate filter with an
        (m, t) ``candidate_mode`` (filtered slots (-inf, -1)).  OAA: the
        top-k of the float32 logits, ties to the lowest id;
        ``estimator`` and ``candidate_mode`` are ignored."""
        cfg = self.cfg
        if cfg.mach is None:
            return ref.topk_lowest_id(
                self.oaa_logits(params, hidden).to(torch.float32), k)
        est = estimator or cfg.mach.estimator
        filtered = candidate_mode not in (None, ops.CANDIDATE_EXACT)
        inverted = self.mach_inverted_table(hidden.device) if filtered else None
        return ops.mach_topk(self._meta_probs(params, hidden),
                             num_classes=cfg.vocab_size, k=k, estimator=est,
                             candidate_mode=candidate_mode, inverted=inverted,
                             **self._hash_kw(hidden.device))

    def topk_candidates(self, params: dict, hidden: torch.Tensor, top_k: int,
                        estimator: Optional[str] = None, candidate_mode=None):
        """Top-k sampling candidates (vals, idxs), each (B, top_k), on the
        sampling scale: unbiased values go back to the summed-score scale
        (× r·(b−1)/b, the inverse of Eq. 2 up to a per-row constant that
        cancels in the categorical); min / median keep their own.  OAA:
        the logits."""
        cfg = self.cfg
        vals, idxs = self.topk_scores(params, hidden, top_k, estimator,
                                      candidate_mode)
        if cfg.mach is not None and \
                (estimator or cfg.mach.estimator) == "unbiased":
            r, b = cfg.mach.num_repetitions, cfg.mach.num_buckets
            vals = vals * (r * (b - 1.0) / b)
        return vals, idxs

    @staticmethod
    def sample_from_candidates(vals: torch.Tensor, idxs: torch.Tensor,
                               gumbel: torch.Tensor, *, temperature=1.0,
                               row_top_k: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """Temperature / top-k categorical pick over (B, k) candidates by
        the Gumbel-max rule: argmax(vals / T + gumbel) over each row's
        first ``row_top_k`` (clamped to [1, k]) candidates.  ``gumbel``
        (B, k) float32 carries the randomness, so the caller decides whose
        stream each row draws from.  A row at temperature ~0 with
        row_top_k 1 picks its top candidate whatever the noise."""
        top_k = vals.shape[-1]
        temp = torch.clamp(torch.as_tensor(temperature, dtype=torch.float32,
                                           device=vals.device), min=1e-6)
        if temp.dim():
            temp = temp[:, None]
        logits = vals / temp
        if row_top_k is not None:
            row_k = torch.clamp(row_top_k.to(torch.int64), 1, top_k)
            rank = torch.arange(top_k, device=vals.device)[None]
            logits = torch.where(rank < row_k[:, None], logits, -torch.inf)
        pick = torch.argmax(logits + gumbel, dim=-1)
        return torch.gather(idxs, 1, pick[:, None])[:, 0].to(torch.int32)

    def sample_token(self, params: dict, hidden: torch.Tensor,
                     generator: torch.Generator, *, temperature=1.0,
                     top_k: int = 50,
                     row_top_k: Optional[torch.Tensor] = None,
                     estimator: Optional[str] = None) -> torch.Tensor:
        """Top-k temperature sampling from final hidden states (B, d),
        the noise drawn from ``generator`` (on ``hidden``'s device)."""
        vals, idxs = self.topk_candidates(params, hidden, top_k, estimator)
        u = torch.rand(vals.shape, generator=generator, device=vals.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        return self.sample_from_candidates(
            vals, idxs, -torch.log(-torch.log(u)), temperature=temperature,
            row_top_k=row_top_k)

"""Training loop: the train step, microbatching, clipping, metrics.

``make_train_step`` returns the (state, batch) -> (state, metrics) step:
``accumulate_grads`` -> ``clip_by_global_norm`` -> ``opt.update`` ->
``apply_updates``, as in the JAX package, run eagerly on the params'
device.  MACH enters through the model's loss (the R-head hashed
cross-entropy); nothing in the loop is MACH-specific.

On a mesh (``Trainer(mesh=, rules=)``, ``DataParallel``) the state is
sharded FSDP-style: every leaf a ``DTensor`` placed by
``sharding.state_shardings``.  A step hands the model the placed params
and this rank's rows of the global batch.  The model gathers each leaf
where it uses it (``sharding.materialize``: the embedding at the
lookup, each layer period's slices inside the period, recomputed under
remat), so every kernel sees plain whole tensors as on one device and a
rank holds about one period whole at a time, as JAX's scan does.  The
backward reduce-scatters each use's gradient onto its param's
placements as it leaves the use; clipping and the optimizer run on the
``DTensor`` state.  Two parts split on the ``model`` axis instead of
running there as replicas.  Where the mesh axes that split the MACH
head's R·B columns divide R, each rank computes only its own
repetitions (kernel 3 or 4 on R/n heads) and the per-token losses are
summed over those ranks (``sharding.head_split``).  Where the rules
shard a decoder block's ``heads`` (and ``mlp``) dims, each rank
computes its self-attention on its H/n query heads (kernel 10 on them)
and its MLP on its d_ff/n columns, and the two outputs are summed over
those ranks (``sharding.block_split``).  The embedding, the OAA head,
the MoE experts, the RG-LRU, the xLSTM blocks and the cross-attention
run on ``model`` as replicas.  The loss is the global batch's weighted
mean, as on one device; at world size 1 the step computes the same bits
as the single-device one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.checkpoint import tree_flatten
from repro_torch.models.transformer import AUX_KEYS
from repro_torch.optim import (accumulate_grads, apply_updates,
                               clip_by_global_norm, make_optimizer,
                               make_schedule)
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.sharding import (ShardingRules, activate, batch_shardings,
                                  place, state_shardings)
from repro_torch.sharding.partitioning import mesh_device, spec_axes
from repro_torch.train.train_state import TrainState, new_train_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "warmup_cosine"
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    num_microbatches: int = 1
    master_weights: bool = False     # f32 masters for bf16 params
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10


def make_optimizer_from_config(tcfg: TrainConfig):
    if tcfg.schedule == "warmup_cosine":
        sched = make_schedule("warmup_cosine", peak=tcfg.peak_lr,
                              warmup_steps=tcfg.warmup_steps,
                              total_steps=tcfg.total_steps)
    elif tcfg.schedule == "constant":
        sched = make_schedule("constant", value=tcfg.peak_lr)
    else:
        sched = make_schedule(tcfg.schedule, peak=tcfg.peak_lr,
                              warmup_steps=tcfg.warmup_steps)
    kw = {}
    if tcfg.optimizer in ("adamw",):
        kw["weight_decay"] = tcfg.weight_decay
    return make_optimizer(tcfg.optimizer, sched,
                          master_weights=tcfg.master_weights, **kw), sched


class DataParallel:
    """The mesh half of a sharded train step: which rows of the global
    batch this rank computes, the global weighted mean as each rank's
    share of the loss, the mesh axes the rows split on (the model's
    gathers sum their gradients over them; a MACH head split by
    repetition reads them too), and the metrics summed over the ranks
    that hold different rows.  The loss reaches it whole on every rank
    of a row shard: a split head's partial losses are summed before the
    weighted mean.

    ``group_size``: an MoE model's token groups, whose per-group means
    (``load_balance``, ``router_z``) equal one device's only where no
    group straddles two ranks; a batch whose rows split otherwise is
    refused."""

    def __init__(self, mesh, rules: ShardingRules, group_size: int = 0):
        self.mesh = mesh
        self.rules = rules
        self.group_size = group_size
        # set by ``local_rows`` for the step's other calls: the mesh axes
        # the batch rows split on, their shard count, and a sum's
        # placements (partial over those axes, the same on the others)
        self.batch_axes, self._shards, self._partial = None, 1, None

    def local_rows(self, batch: dict, num_microbatches: int) -> dict:
        """This rank's rows of the global ``batch``: of each microbatch
        (the global batch split on its leading dim, as one device splits
        it) the rows its batch shard holds, shard index major over the
        mesh axes (``pod`` before ``data``)."""
        names = self.mesh.mesh_dim_names
        specs = {s.spec[:1] for _, s in tree_flatten(
            batch_shardings(self.mesh, self.rules, batch))}
        if len(specs) != 1:
            raise ValueError(f"batch leaves split their rows differently: "
                             f"{specs}")
        axes = spec_axes((specs.pop() or (None,))[0])
        self.batch_axes = axes
        self._partial = [Partial("sum") if a in axes else Replicate()
                         for a in names]
        coord = self.mesh.get_coordinate()
        idx, n = 0, 1
        for a in axes:
            size = self.mesh.size(names.index(a))
            idx, n = idx * size + coord[names.index(a)], n * size
        self._shards = n

        def rows(x):
            b = x.shape[0]
            if b % (n * num_microbatches):
                raise ValueError(f"batch {b} does not split into "
                                 f"{num_microbatches} microbatches over "
                                 f"{n} shards")
            return x.reshape((num_microbatches, n, -1) + tuple(x.shape[1:])
                             )[:, idx].reshape((-1,) + tuple(x.shape[1:]))

        local = tree_map(rows, batch)
        if self.group_size:
            t = local["tokens"].shape[1] - 1
            if "prefix_feats" in local:
                t += local["prefix_feats"].shape[1]
            per_mb = local["tokens"].shape[0] // num_microbatches * t
            if per_mb % self.group_size:
                raise ValueError(
                    f"{per_mb} tokens a rank and microbatch do not fill "
                    f"whole MoE groups of {self.group_size}: a group would "
                    f"straddle two ranks")
        return local

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks that hold different rows."""
        return DTensor.from_local(x, self.mesh, self._partial,
                                  run_check=False).full_tensor()

    def global_mean(self, loss_fn):
        """``loss_fn`` (its metrics ``loss`` and ``tokens``: the weighted
        mean and the weight sum) as this rank's share of the global
        batch's loss: ``loss`` times clamp(local weights, 1) / clamp(all
        weights, 1), an MoE model's aux terms divided by the shard count.
        Summed over the shards, value, gradients and metrics are one
        device's."""
        def shared(params, batch):
            total, m = loss_fn(params, batch)
            if "tokens" not in m:
                raise ValueError("a sharded step needs the loss's "
                                 "'tokens' metric (the weight sum)")
            w = m["tokens"].detach()
            share = torch.clamp(w, min=1.0) / torch.clamp(self._sum(w),
                                                          min=1.0)
            out = m["loss"] * share
            metrics = {**m, "loss": out.detach()}
            aux = [k for k in AUX_KEYS if k in m]
            if aux:
                out = out + (total - m["loss"]) / self._shards
                metrics.update({k: m[k] / self._shards for k in aux})
            return out, metrics

        return shared

    def reduce_metrics(self, metrics: dict) -> dict:
        keys = sorted(metrics)
        summed = self._sum(torch.stack([metrics[k].to(torch.float32)
                                        for k in keys]))
        return {k: summed[i].to(metrics[k].dtype)
                for i, k in enumerate(keys)}


def make_train_step(loss_fn: Callable[[Any, dict], tuple],
                    tcfg: TrainConfig,
                    data_parallel: Optional[DataParallel] = None):
    """loss_fn(params, batch) -> (loss, metrics).  Returns (the step
    (state, batch) -> (state, metrics), the optimizer).  Metrics gain
    ``grad_norm`` (before clipping) and ``lr``; the loss's own (an MoE
    model's ``load_balance`` and ``router_z``) pass through.  With
    ``data_parallel`` the state is sharded on its mesh and ``batch`` is
    the global batch, the same on every rank; the step runs the loss
    inside ``activate(mesh, rules, batch_axes)``, where the model
    gathers its params and splits its MACH head by repetition."""
    opt, sched = make_optimizer_from_config(tcfg)
    dp = data_parallel

    def step_fn(state: TrainState, batch: dict):
        loss, scope = loss_fn, contextlib.nullcontext()
        if dp is not None:
            batch = dp.local_rows(batch, tcfg.num_microbatches)
            loss = dp.global_mean(loss_fn)
            # the model's gathers sum their gradients over the batch axes
            scope = activate(dp.mesh, dp.rules, dp.batch_axes)
        with scope:
            (_, metrics), grads = accumulate_grads(
                loss, state.params, batch, tcfg.num_microbatches)
        if dp is not None:
            metrics = dp.reduce_metrics(metrics)
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        del grads       # freed before the new params exist: the step's peak
        params = apply_updates(state.params, updates)
        metrics = dict(metrics)
        metrics["grad_norm"] = (gnorm.full_tensor()
                                if isinstance(gnorm, DTensor) else gnorm)
        metrics["lr"] = sched(state.step)
        return TrainState(state.step + 1, params, opt_state), metrics

    return step_fn, opt


class Trainer:
    """The training loop (examples, tests, ``launch/train.py``), on one
    device or, with ``mesh``, data-parallel over a ``DeviceMesh`` with the
    state sharded by ``rules`` (default ``ShardingRules()``: FSDP); the
    model then needs ``param_axes()``.  Under a mesh every rank runs the
    loop on the same global batches.

    Dynamic bucket selection: ``bucket_proxy_fn(params, batch)`` -> (R, B)
    proxy scores, recomputed every ``refresh_every`` steps (the second
    entry of ``model.cfg.mach_bucket_select``, else every step) under
    ``torch.no_grad`` and injected as ``batch["bucket_proxy"]``.  Without
    it the loss recomputes the proxy each step; under a mesh that proxy,
    the label buckets it forces in and so the selection are the global
    batch's (``ops.mach_fused_xent(split=)``).  ``bucket_proxy_fn`` is
    refused under a mesh: it runs outside the step on whole params
    (ROADMAP.md §1)."""

    def __init__(self, model, tcfg: TrainConfig,
                 loss_fn: Optional[Callable] = None,
                 bucket_proxy_fn: Optional[Callable] = None,
                 mesh=None, rules: Optional[ShardingRules] = None):
        self.model = model
        self.tcfg = tcfg
        self.loss_fn = loss_fn or model.loss
        self.mesh = mesh
        self.state_shardings = None
        dp = None
        cfg = getattr(model, "cfg", None)
        if mesh is not None:
            rules = rules or ShardingRules()
            if rules.sp:
                raise ValueError("sequence parallelism (rules.sp) is not "
                                 "ported yet (ROADMAP.md §1)")
            if bucket_proxy_fn is not None:
                raise ValueError("bucket_proxy_fn under a mesh: the cached "
                                 "proxy is computed outside the step on "
                                 "whole params; the in-loss proxy "
                                 "(mach_bucket_select without it) is the "
                                 "global batch's (ROADMAP.md §1)")
            opt, _ = make_optimizer_from_config(tcfg)
            self.state_shardings = state_shardings(mesh, rules, model,
                                                   opt)[1]
            dp = DataParallel(mesh, rules, cfg.moe_group_size if getattr(
                cfg, "num_experts", 0) else 0)
        self.step_fn, self.opt = make_train_step(self.loss_fn, tcfg, dp)
        self.bucket_proxy_fn = bucket_proxy_fn
        sel = getattr(getattr(model, "cfg", None), "mach_bucket_select", None)
        self._proxy_every = sel[1] if sel is not None and len(sel) > 1 else 1
        self._proxy = None

    def _with_bucket_proxy(self, state: TrainState, batch, step: int):
        """Refresh the cached proxy on schedule and hand it to the loss.
        Selection itself runs in the loss on the current batch, so a stale
        proxy changes only which other buckets the loss sees."""
        if self.bucket_proxy_fn is None or not isinstance(batch, dict):
            return batch
        if self._proxy is None or step % max(self._proxy_every, 1) == 0:
            with torch.no_grad():
                self._proxy = self.bucket_proxy_fn(state.params, batch)
        return {**batch, "bucket_proxy": self._proxy}

    def init_state(self, generator: Optional[torch.Generator] = None,
                   device=None) -> TrainState:
        """Params from ``model.init(generator, device)`` (default
        ``cuda``; under a mesh, the mesh's device) and a fresh optimizer
        state.  Under a mesh every rank draws the whole params from the
        same generator seed and keeps its shards (``state_shardings``);
        the optimizer state is then built on the placed params, so
        moments and master weights are never whole (the few leaves the
        optimizer makes plain, Adafactor's factored moments, are placed
        after)."""
        if self.mesh is None:
            return new_train_state(self.model.init(generator, device),
                                   self.opt)
        params = place(
            self.model.init(generator, device or mesh_device(self.mesh)),
            self.state_shardings.params)
        return place(new_train_state(params, self.opt), self.state_shardings)

    def fit(self, state: TrainState, stream, num_steps: int, manager=None,
            monitor=None, log=print) -> TrainState:
        """``num_steps`` steps on ``stream.batch_at(step)``.  ``monitor``
        (a ``StragglerMonitor``) gets each step's time, synchronized;
        ``manager`` (a ``CheckpointManager``) a non-blocking save every
        ``checkpoint_every`` steps and a blocking one at the end (which
        takes the place of a periodic save at the last step)."""
        start = state.step
        end = start + num_steps
        for s in range(start, end):
            t0 = time.perf_counter()
            batch = self._with_bucket_proxy(state, stream.batch_at(s), s)
            state, metrics = self.step_fn(state, batch)
            slow = False
            if monitor is not None:
                leaf = tree_leaves(state.params)[0]
                if leaf.device.type == "cuda":
                    torch.cuda.synchronize(leaf.device)
                slow = monitor.record(s, time.perf_counter() - t0)
            if (manager is not None and s + 1 < end
                    and (s + 1) % self.tcfg.checkpoint_every == 0):
                manager.save(s + 1, state, blocking=False)
            if (s + 1) % self.tcfg.log_every == 0 and log:
                moe = "".join(f"{k}={float(metrics[k]):.4f} "
                              for k in ("load_balance", "router_z")
                              if k in metrics)
                log(f"step {s+1}: loss={float(metrics['loss']):.4f} {moe}"
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e}"
                    f"{'  [straggler]' if slow else ''}")
        if manager is not None:
            manager.save(end, state, blocking=True)
        return state

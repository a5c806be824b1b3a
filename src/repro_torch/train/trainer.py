"""Training loop: the train step, microbatching, clipping, metrics.

``make_train_step`` returns the (state, batch) -> (state, metrics) step:
``accumulate_grads`` -> ``clip_by_global_norm`` -> ``opt.update`` ->
``apply_updates``, as in the JAX package, run eagerly on the params'
device.  MACH enters through the model's loss (the R-head hashed
cross-entropy); nothing in the loop is MACH-specific.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.optim import (accumulate_grads, apply_updates,
                               clip_by_global_norm, make_optimizer,
                               make_schedule)
from repro_torch.optim.optimizers import tree_leaves
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


def make_train_step(loss_fn: Callable[[Any, dict], tuple],
                    tcfg: TrainConfig):
    """loss_fn(params, batch) -> (loss, metrics).  Returns (the step
    (state, batch) -> (state, metrics), the optimizer).  Metrics gain
    ``grad_norm`` (before clipping) and ``lr``."""
    opt, sched = make_optimizer_from_config(tcfg)

    def step_fn(state: TrainState, batch: dict):
        (loss, metrics), grads = accumulate_grads(
            loss_fn, state.params, batch, tcfg.num_microbatches)
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        del grads       # freed before the new params exist: the step's peak
        params = apply_updates(state.params, updates)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = sched(state.step)
        return TrainState(state.step + 1, params, opt_state), metrics

    return step_fn, opt


class Trainer:
    """Single-device training loop (examples, tests, ``launch/train.py``).

    Dynamic bucket selection: ``bucket_proxy_fn(params, batch)`` -> (R, B)
    proxy scores, recomputed every ``refresh_every`` steps (the second
    entry of ``model.cfg.mach_bucket_select``, else every step) under
    ``torch.no_grad`` and injected as ``batch["bucket_proxy"]``.  Without
    it the loss recomputes the proxy each step."""

    def __init__(self, model, tcfg: TrainConfig,
                 loss_fn: Optional[Callable] = None,
                 bucket_proxy_fn: Optional[Callable] = None):
        self.model = model
        self.tcfg = tcfg
        self.loss_fn = loss_fn or model.loss
        self.step_fn, self.opt = make_train_step(self.loss_fn, tcfg)
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
        ``cuda``) and a fresh optimizer state."""
        return new_train_state(self.model.init(generator, device), self.opt)

    def fit(self, state: TrainState, stream, num_steps: int, monitor=None,
            log=print) -> TrainState:
        """``num_steps`` steps on ``stream.batch_at(step)``; ``monitor``
        (a ``StragglerMonitor``) gets each step's time, synchronized."""
        start = state.step
        for s in range(start, start + num_steps):
            t0 = time.perf_counter()
            batch = self._with_bucket_proxy(state, stream.batch_at(s), s)
            state, metrics = self.step_fn(state, batch)
            if monitor is not None:
                leaf = tree_leaves(state.params)[0]
                if leaf.device.type == "cuda":
                    torch.cuda.synchronize(leaf.device)
                monitor.record(s, time.perf_counter() - t0)
            if (s + 1) % self.tcfg.log_every == 0 and log:
                log(f"step {s+1}: loss={float(metrics['loss']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e}")
        return state

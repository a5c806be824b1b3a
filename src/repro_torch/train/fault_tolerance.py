"""Fault tolerance: checkpoint-restart, stragglers, elastic moves (the
JAX package's ``repro/train/fault_tolerance.py``, on one device).

* ``run_with_restarts`` — supervisor loop: restore the latest checkpoint
  (or init) → train → on any exception, restore and re-enter.  With the
  step-indexed data stream (``data/lm.py``) a restart consumes exactly
  the batches the failed run would have.
* ``StragglerMonitor`` — per-step wall-time EWMA + z-score; steps slower
  than ``threshold_sigma`` are flagged.
* ``reshard_state`` — the elastic path on one device: checkpoints hold
  plain host arrays, so a state moves to another device leaf by leaf
  (mesh placements wait for multi-device, ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import (CheckpointManager, tree_flatten,
                                    tree_unflatten)
from repro_torch.train.train_state import TrainState


class StragglerMonitor:
    """EWMA-based step-time anomaly detector."""

    def __init__(self, alpha: float = 0.1, threshold_sigma: float = 3.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold_sigma
        self.warmup = warmup
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.count = 0
        self.flagged: list = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = False
        if self.count > self.warmup:
            sigma = math.sqrt(self.var) if self.var > 0 else self.mean * 0.1
            if dt > self.mean + self.threshold * max(sigma, 1e-9):
                is_straggler = True
                self.flagged.append((step, dt, self.mean))
        # EWMA update (skip updating stats with outliers so one straggler
        # doesn't mask the next)
        if not is_straggler:
            delta = dt - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var
                                           + self.alpha * delta * delta)
        return is_straggler


def reshard_state(state: Any, device) -> Any:
    """Every tensor leaf of ``state`` moved to ``device`` (ints stay)."""
    device = torch.device(device)
    return tree_unflatten(state, [
        x.to(device) if isinstance(x, torch.Tensor) else x
        for _, x in tree_flatten(state)])


def run_with_restarts(train_once: Callable[[TrainState, int], TrainState],
                      init_state_fn: Callable[[], TrainState],
                      manager: CheckpointManager,
                      total_steps: int,
                      max_restarts: int = 10,
                      log=print) -> TrainState:
    """Supervisor: restore latest (or init), run, restart on exception.

    ``train_once(state, remaining_steps)`` must checkpoint through
    ``manager`` as it goes; on any exception the supervisor restores the
    last durable step and re-enters, so progress is monotone.
    """
    restarts = 0
    while True:
        template = init_state_fn()
        step = manager.latest_step()
        if step is not None:
            state, step = manager.restore(template, step)
            del template
            if log:
                log(f"[ft] restored checkpoint at step {step}")
        else:
            state, step = template, 0
        remaining = total_steps - int(state.step)
        if remaining <= 0:
            return state
        try:
            state = train_once(state, remaining)
            if int(state.step) >= total_steps:
                return state
        except Exception as e:  # noqa: BLE001 — any worker failure
            restarts += 1
            if restarts > max_restarts:
                raise
            if log:
                log(f"[ft] failure at ~step {manager.latest_step()}: "
                    f"{type(e).__name__}: {e} — restarting "
                    f"({restarts}/{max_restarts})")
        del state       # freed before the next template is drawn

"""Step-time anomaly detection (the JAX package's ``StragglerMonitor``).

``run_with_restarts`` and ``reshard_state`` wait for checkpoints and
multi-device (ROADMAP.md)."""

from __future__ import annotations

import math
from typing import Optional


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

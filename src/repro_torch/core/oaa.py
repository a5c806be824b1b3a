"""One-vs-all (OAA) baseline: the paper's comparison point.

A plain K-way softmax (logistic) classifier with O(Kd) parameters and
O(Kd) multiplications a prediction, so every MACH experiment can report
the paper's accuracy / memory trade-off against the exact baseline
(paper §4.2).  The port of ``repro/core/oaa.py``: a matrix product and a
softmax, no kernel of its own.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.mach import _normal, _weighted_mean


class OAAClassifier:
    """Softmax regression: W (d, K), b (K)."""

    def __init__(self, num_classes: int, dim: int):
        self.num_classes = num_classes
        self.dim = dim

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        """N(0, 1/d) weights drawn from ``generator``, zero bias."""
        device = resolve_device(device)
        w = _normal((self.dim, self.num_classes), generator, device)
        return {"w": w.mul_(1.0 / math.sqrt(self.dim)),
                "b": torch.zeros((self.num_classes,), dtype=torch.float32,
                                 device=device)}

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return x @ params["w"] + params["b"]

    def loss(self, params: dict, x: torch.Tensor, y: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean (optionally weighted) softmax cross-entropy."""
        lg = self.logits(params, x)
        logp = lg - torch.logsumexp(lg, dim=-1, keepdim=True)
        nll = -torch.gather(logp, -1, y.long()[..., None])[..., 0]
        return _weighted_mean(nll, weights)

    def predict(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits(params, x), dim=-1)

    def class_probs(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.logits(params, x), dim=-1)

    def param_count(self) -> int:
        return self.dim * self.num_classes + self.num_classes

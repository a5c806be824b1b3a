"""Learning-rate schedules (pure functions of the step count).

Each returns a float32 0-d tensor on the CPU, computed in float32 as the
JAX package's schedules are; a CPU 0-d tensor multiplies a tensor on any
device.
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(value: float):
    return lambda step: _f32(value)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = _f32(step)
        return peak * torch.clamp((s + 1) / max(1, warmup_steps), max=1.0)
    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  end_value: float = 0.0):
    def fn(step):
        s = _f32(step)
        warm = peak * torch.clamp((s + 1) / max(1, warmup_steps), max=1.0)
        frac = torch.clamp((s - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = end_value + 0.5 * (peak - end_value) \
            * (1 + torch.cos(_f32(math.pi) * frac))
        return torch.where(s < warmup_steps, warm, cos)
    return fn


def warmup_rsqrt(peak: float, warmup_steps: int):
    """Transformer-style inverse-sqrt decay."""
    def fn(step):
        s = _f32(step) + 1
        w = max(1, warmup_steps)
        return peak * torch.minimum(s / w, torch.sqrt(w / s))
    return fn


def make_schedule(name: str, **kw):
    return {"constant": constant, "linear_warmup": linear_warmup,
            "warmup_cosine": warmup_cosine,
            "warmup_rsqrt": warmup_rsqrt}[name](**kw)

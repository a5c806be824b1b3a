"""Optimizers, schedules and gradient utilities on dicts of tensors —
the JAX package's ``repro.optim`` with the same names and defaults."""

from repro_torch.optim.grad import (accumulate_grads, clip_by_global_norm,
                                    global_norm, value_and_grad)
from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          apply_updates, sgd)
from repro_torch.optim.schedules import (constant, linear_warmup,
                                         make_schedule, warmup_cosine,
                                         warmup_rsqrt)

__all__ = [
    "Optimizer", "sgd", "adam", "adamw", "apply_updates",
    "constant", "linear_warmup", "warmup_cosine", "warmup_rsqrt",
    "make_schedule", "accumulate_grads", "clip_by_global_norm",
    "global_norm", "value_and_grad",
]

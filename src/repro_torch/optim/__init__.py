"""Optimizers, schedules, gradient utilities and gradient compression
on dicts of tensors — the JAX package's ``repro.optim`` with the same
names and defaults."""

from repro_torch.optim.grad import (ErrorFeedbackState, Quantized,
                                    accumulate_grads, clip_by_global_norm,
                                    dequantize_8bit, global_norm,
                                    init_error_feedback, quantize_8bit,
                                    topk_compress, value_and_grad)
from repro_torch.optim.optimizers import (Optimizer, adafactor, adam, adamw,
                                          apply_updates, make_optimizer, sgd,
                                          with_master_weights)
from repro_torch.optim.schedules import (constant, linear_warmup,
                                         make_schedule, warmup_cosine,
                                         warmup_rsqrt)

__all__ = [
    "Optimizer", "sgd", "adam", "adamw", "adafactor", "apply_updates",
    "make_optimizer", "with_master_weights",
    "constant", "linear_warmup", "warmup_cosine", "warmup_rsqrt",
    "make_schedule", "accumulate_grads", "clip_by_global_norm",
    "global_norm", "value_and_grad", "ErrorFeedbackState",
    "init_error_feedback", "topk_compress", "Quantized", "quantize_8bit",
    "dequantize_8bit",
]

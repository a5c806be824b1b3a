"""phi3-mini-3.8b [dense] — 32L, d_model=3072, 32H (MHA kv=32),
d_ff=8192, vocab=32064.  RoPE SwiGLU.  [arXiv:2404.14219]
"""

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "phi3-mini-3.8b"


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32064,
        activation="swiglu", norm="rmsnorm",
        mach=default_mach_head(32064, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        activation="swiglu", norm="rmsnorm",
        dtype=torch.float32, scan_layers=False, remat="none",
    )

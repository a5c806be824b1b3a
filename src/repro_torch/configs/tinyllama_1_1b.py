"""tinyllama-1.1b [dense] — 22L, d_model=2048, 32H (GQA kv=4),
d_ff=5632, vocab=32000.  llama2-arch small.  [arXiv:2401.02385; hf]
Also the ~100M-scale end-to-end training example's parent arch.
"""

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "tinyllama-1.1b"


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
        d_ff=5632, vocab_size=32000,
        activation="swiglu", norm="rmsnorm",
        mach=default_mach_head(32000, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=176, vocab_size=256,
        activation="swiglu", norm="rmsnorm",
        dtype=torch.float32, scan_layers=False, remat="none",
    )

"""granite-20b [dense] — 52L, d_model=6144, 48H (MQA kv=1), d_ff=24576,
vocab=49152.  Code model.  [arXiv:2405.04324; hf]

d_ff = 4·d_model with a *non-gated* MLP (GPT-BigCode lineage) — a gated
SwiGLU at this width would be a 28B model, not 20B.
"""

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "granite-20b"


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152,
        activation="gelu", norm="layernorm",
        mach=default_mach_head(49152, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=192, vocab_size=256,
        activation="gelu", norm="layernorm",
        dtype=torch.float32, scan_layers=False, remat="none",
    )

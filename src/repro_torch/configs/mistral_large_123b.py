"""mistral-large-123b [dense] — 88L, d_model=12288, 96H (GQA kv=8),
d_ff=28672, vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407]
Small vocab -> OAA head by default (MACH supported via flag); at 123 B
params the trunk, not the head, is the memory story — FSDP + TP carry it.
"""

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "mistral-large-123b"


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
        d_ff=28672, vocab_size=32768,
        activation="swiglu", norm="rmsnorm", rope_theta=1e6,
        mach=default_mach_head(32768, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=3, d_model=96, num_heads=6, num_kv_heads=2,
        d_ff=192, vocab_size=256,
        activation="swiglu", norm="rmsnorm",
        dtype=torch.float32, scan_layers=False, remat="none",
    )

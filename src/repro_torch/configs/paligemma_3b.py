"""paligemma-3b [vlm] — 18L, d_model=2048, 8H (MQA kv=1), d_ff=16384,
vocab=257216.  SigLIP frontend stubbed (256 patch embeddings via
input_specs) + gemma decoder.  [arXiv:2407.07726; hf]
Largest head of the pool: 527M params -> 33.5M with MACH (B=2048, R=8).
"""

import math

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "paligemma-3b"
NUM_PATCHES = 256


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        d_ff=16384, vocab_size=257216,
        activation="geglu", norm="rmsnorm",
        frontend="vision", num_prefix_tokens=NUM_PATCHES,
        tie_embeddings=True, embed_scale=math.sqrt(2048.0),
        mach=default_mach_head(257216, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=192, vocab_size=512,
        activation="geglu", norm="rmsnorm",
        frontend="vision", num_prefix_tokens=4,
        tie_embeddings=True, embed_scale=8.0,
        mach=default_mach_head(512, "on", num_buckets=32, num_repetitions=4),
        dtype=torch.float32, scan_layers=False, remat="none",
    )

"""mixtral-8x22b [moe] — 56L, d_model=6144, 48H (GQA kv=8),
d_ff=16384 per expert, vocab=32768, 8 experts top-2, SWA.
[arXiv:2401.04088; hf]  SWA (window 4096) qualifies it for long_500k.
At about 141 B parameters (282 GB in bf16) it does not fit one card.
"""

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "mixtral-8x22b"


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        block_pattern=("moe",),
        num_experts=8, experts_top_k=2, moe_d_ff=16384,
        moe_group_size=512,   # the routing group (JAX: the dispatch one-hots' size)
        attention_kind="sliding_window", window=4096,
        activation="swiglu", norm="rmsnorm", rope_theta=1e6,
        mach=default_mach_head(32768, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        block_pattern=("moe",),
        num_experts=4, experts_top_k=2, moe_d_ff=96, moe_group_size=16,
        attention_kind="sliding_window", window=8,
        activation="swiglu", norm="rmsnorm",
        dtype=torch.float32, scan_layers=False, remat="none",
    )

"""qwen2-moe-a2.7b [moe] — 24L, d_model=2048, 16H (MHA kv=16),
moe_d_ff=1408, vocab=151936, 60 routed experts top-4 + 4 shared.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
Extreme vocab (152k) -> MACH head on by default; the 311M-parameter
unembedding dwarfs each MoE layer — the paper's prime LM target.
"""

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "qwen2-moe-a2.7b"


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=151936,
        block_pattern=("moe",),
        num_experts=60, experts_top_k=4, moe_d_ff=1408,
        num_shared_experts=4, shared_d_ff=5632,
        moe_group_size=512,
        activation="swiglu", norm="rmsnorm",
        mach=default_mach_head(151936, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=48, vocab_size=512,
        block_pattern=("moe",),
        num_experts=6, experts_top_k=2, moe_d_ff=48,
        num_shared_experts=2, shared_d_ff=96, moe_group_size=16,
        activation="swiglu", norm="rmsnorm",
        mach=default_mach_head(512, "on", num_buckets=32, num_repetitions=4),
        dtype=torch.float32, scan_layers=False, remat="none",
    )

"""recurrentgemma-2b [hybrid] — 26L, d_model=2560, 10H (MQA kv=1),
d_ff=7680, vocab=256000.  RG-LRU + local attention, pattern
(recurrent, recurrent, attention) cycled — Griffin.  [arXiv:2402.19427]
Extreme vocab (256k) -> MACH head on by default.
"""

import math

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "recurrentgemma-2b"


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        d_ff=7680, vocab_size=256000,
        block_pattern=("rglru", "rglru", "attn_local"),
        local_window=2048, rnn_width=2560,
        activation="geglu", norm="rmsnorm",
        tie_embeddings=True, embed_scale=math.sqrt(2560.0),
        mach=default_mach_head(256000, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        num_layers=5, d_model=64, num_heads=2, num_kv_heads=1,
        d_ff=128, vocab_size=256,
        block_pattern=("rglru", "rglru", "attn_local"),
        local_window=8, rnn_width=64,
        activation="geglu", norm="rmsnorm",
        tie_embeddings=True, embed_scale=8.0,
        mach=default_mach_head(256, "on", num_buckets=16, num_repetitions=4),
        dtype=torch.float32, scan_layers=False, remat="none",
    )

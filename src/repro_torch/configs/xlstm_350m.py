"""xlstm-350m [ssm] — 24L, d_model=1024, 4H, d_ff=0 (blocks carry their
own projections), vocab=50304.  Alternating mLSTM/sLSTM blocks.
[arXiv:2405.04517]  Attention-free, O(1) decode state -> long_500k runs.
"""

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "xlstm-350m"


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="xlstm",
        num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=("mlstm", "slstm"),
        activation="geglu", norm="layernorm",
        mach=default_mach_head(50304, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="xlstm",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=256,
        block_pattern=("mlstm", "slstm"),
        activation="geglu", norm="layernorm",
        dtype=torch.float32, scan_layers=False, remat="none",
    )

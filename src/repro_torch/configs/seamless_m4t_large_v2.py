"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone.

24L(enc)+24L(dec), d_model=1024, 16H (MHA, kv=16), d_ff=8192,
vocab=256206.  [arXiv:2308.11596; hf]  Audio frontend stubbed:
input_specs provide precomputed w2v-BERT frame embeddings.
Extreme vocab (256k) -> MACH head on by default.
"""

import torch

from repro_torch.configs.common import default_mach_head
from repro_torch.models.transformer import ModelConfig

ARCH_ID = "seamless-m4t-large-v2"


def full_config(mach: str = "auto") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="enc_dec",
        num_layers=24, num_encoder_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=256206,
        activation="gelu", norm="layernorm",
        frontend="audio",
        mach=default_mach_head(256206, mach),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="enc_dec",
        num_layers=2, num_encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        activation="gelu", norm="layernorm",
        frontend="audio",
        mach=default_mach_head(256, "on", num_buckets=16, num_repetitions=4),
        dtype=torch.float32, scan_layers=False, remat="none",
    )

"""Config helpers shared by the per-architecture files."""

from __future__ import annotations

from typing import Optional

from repro_torch.core.mach import MACHConfig
from repro_torch.models.transformer import ModelConfig

# The four assigned LM shapes: (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def default_mach_head(vocab_size: int, enable: str = "auto",
                      num_buckets: int = 2048, num_repetitions: int = 8
                      ) -> Optional[MACHConfig]:
    """Framework policy: MACH replaces the softmax head where the vocab
    is extreme (>=100k).  'on'/'off' force it either way."""
    if enable == "off":
        return None
    if enable == "auto" and vocab_size < 100_000:
        return None
    return MACHConfig(num_classes=vocab_size, num_buckets=num_buckets,
                      num_repetitions=num_repetitions, seed=0,
                      estimator="unbiased", hash_kind="mult_shift")


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM/hybrid/SWA)."""
    if cfg.family in ("hybrid", "xlstm"):
        return True
    return cfg.attention_kind == "sliding_window"


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Returns (applicable, reason-if-not)."""
    if shape == "long_500k" and not supports_long_context(cfg):
        return False, ("pure full-attention arch: 524288-token dense KV "
                       "cache is the quadratic regime this shape excludes "
                       "(DESIGN.md §5)")
    return True, ""

"""Modality frontends (seamless-m4t's audio, paligemma's vision).

The port of ``repro/models/frontends.py``.  The frontends themselves are
stubs: requests and batches carry precomputed frame or patch features,
and what is trainable here is a linear adapter from those features into
the backbone's d_model (PaLiGemma's multimodal projector, SeamlessM4T's
length-adapted encoder output projection).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers

# feature dims of the stubbed frontends
AUDIO_FEATURE_DIM = 1024     # w2v-BERT 2.0 conformer output (seamless)
VISION_FEATURE_DIM = 1152    # SigLIP-So400m/14 output (paligemma)


def init_adapter(generator, feature_dim: int, d_model: int, device) -> dict:
    return {"proj": layers.init_dense(generator, feature_dim, (d_model,),
                                      device)}


ADAPTER_AXES = {"proj": layers.dense_axes(None, ("embed",))}


def apply_adapter(params: dict, feats: torch.Tensor, dtype) -> torch.Tensor:
    """(B, S, feature_dim) precomputed frontend features -> (B, S, d_model)
    in ``dtype``."""
    return layers.dense(params["proj"], feats.to(dtype))


def frontend_feature_dim(kind: str) -> int:
    if kind == "audio":
        return AUDIO_FEATURE_DIM
    if kind == "vision":
        return VISION_FEATURE_DIM
    raise ValueError(f"unknown frontend {kind!r}")

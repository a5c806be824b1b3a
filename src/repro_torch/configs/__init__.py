"""Configurations: the extreme-classification tasks, and the language
models the port serves (``get_config``)."""

from repro_torch.configs import (granite_20b, mistral_large_123b,
                                 mixtral_8x22b, paligemma_3b, phi3_mini_3_8b,
                                 qwen2_moe_a2_7b, recurrentgemma_2b,
                                 seamless_m4t_large_v2, tinyllama_1_1b,
                                 xlstm_350m)
from repro_torch.configs.common import (SHAPES, default_mach_head,
                                        shape_applicable,
                                        supports_long_context)
from repro_torch.configs.odp_mach import IMAGENET, ODP, ExtremeTaskConfig

_MODULES = {m.ARCH_ID: m for m in (recurrentgemma_2b, tinyllama_1_1b,
                                   phi3_mini_3_8b, granite_20b,
                                   mistral_large_123b, mixtral_8x22b,
                                   qwen2_moe_a2_7b, xlstm_350m,
                                   seamless_m4t_large_v2, paligemma_3b)}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, *, smoke: bool = False, mach: str = "auto"):
    """The ``ModelConfig`` of an architecture (full width unless
    ``smoke``).  Raises ``KeyError`` for an unknown one."""
    try:
        mod = _MODULES[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}") from None
    return mod.smoke_config() if smoke else mod.full_config(mach=mach)


__all__ = ["ARCH_IDS", "ExtremeTaskConfig", "IMAGENET", "ODP", "SHAPES",
           "default_mach_head", "get_config", "shape_applicable",
           "supports_long_context"]

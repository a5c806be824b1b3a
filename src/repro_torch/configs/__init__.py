"""Configurations: the extreme-classification tasks, and the language
models the port serves (``get_config``)."""

from repro_torch.configs import (granite_20b, mistral_large_123b,
                                 mixtral_8x22b, phi3_mini_3_8b,
                                 qwen2_moe_a2_7b, recurrentgemma_2b,
                                 tinyllama_1_1b)
from repro_torch.configs.common import (SHAPES, default_mach_head,
                                        shape_applicable,
                                        supports_long_context)
from repro_torch.configs.odp_mach import IMAGENET, ODP, ExtremeTaskConfig

_MODULES = {m.ARCH_ID: m for m in (recurrentgemma_2b, tinyllama_1_1b,
                                   phi3_mini_3_8b, granite_20b,
                                   mistral_large_123b, mixtral_8x22b,
                                   qwen2_moe_a2_7b)}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, *, smoke: bool = False, mach: str = "auto"):
    """The ``ModelConfig`` of a ported architecture (full width unless
    ``smoke``).  Raises ``KeyError`` for an architecture not ported yet."""
    try:
        mod = _MODULES[arch_id]
    except KeyError:
        raise KeyError(f"arch {arch_id!r} is not ported; ported: "
                       f"{sorted(_MODULES)} (the others are queued in "
                       f"ROADMAP.md)") from None
    return mod.smoke_config() if smoke else mod.full_config(mach=mach)


__all__ = ["ARCH_IDS", "ExtremeTaskConfig", "IMAGENET", "ODP", "SHAPES",
           "default_mach_head", "get_config", "shape_applicable",
           "supports_long_context"]

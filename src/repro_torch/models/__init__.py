from repro_torch.models.model import LanguageModel
from repro_torch.models.transformer import ModelConfig, plan_stacks

__all__ = ["LanguageModel", "ModelConfig", "plan_stacks"]

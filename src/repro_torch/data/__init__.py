from repro_torch.data.extreme import (
    ExtremeDataConfig,
    ExtremeDataset,
    SparseBatch,
    SparseExtremeDataConfig,
    SparseExtremeDataset,
)
from repro_torch.data.lm import LMDataConfig, SyntheticLMStream

__all__ = ["ExtremeDataConfig", "ExtremeDataset", "LMDataConfig",
           "SparseBatch", "SparseExtremeDataConfig", "SparseExtremeDataset",
           "SyntheticLMStream"]

from repro_torch.data.extreme import (
    ExtremeDataConfig,
    ExtremeDataset,
    SparseBatch,
    SparseExtremeDataConfig,
    SparseExtremeDataset,
)

__all__ = ["ExtremeDataConfig", "ExtremeDataset", "SparseBatch",
           "SparseExtremeDataConfig", "SparseExtremeDataset"]

"""MACH core: the paper's contribution on PyTorch tensors."""

from repro_torch.core.hashing import (
    CarterWegmanFamily,
    MultShiftFamily,
    indistinguishable_pair_bound,
    make_hash_family,
    memory_reduction,
    r_required,
)
from repro_torch.core.estimators import (
    ESTIMATORS,
    estimate_class_probs,
    gather_class_probs,
    median_estimator,
    min_estimator,
    predict_classes,
    predict_topk,
    unbiased_estimator,
)
from repro_torch.core.mach import (
    MACHConfig,
    MACHHead,
    MACHLinear,
    MACHOutputHead,
    is_sparse_batch,
    mach_loss,
    mach_meta_probs,
)
from repro_torch.core.oaa import OAAClassifier

__all__ = [
    "CarterWegmanFamily", "MultShiftFamily", "make_hash_family",
    "r_required", "indistinguishable_pair_bound", "memory_reduction",
    "ESTIMATORS", "estimate_class_probs", "gather_class_probs",
    "unbiased_estimator", "min_estimator", "median_estimator",
    "predict_classes", "predict_topk",
    "MACHConfig", "MACHHead", "MACHLinear", "MACHOutputHead",
    "is_sparse_batch", "mach_loss", "mach_meta_probs", "OAAClassifier",
]

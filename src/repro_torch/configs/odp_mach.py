"""The paper's own task configs: ODP and fine-grained ImageNet.

MACHLinear (logistic regression) setups from Table 1/2 of the paper, at
their published widths, plus a reduced CPU-scale stand-in of each.  The
offline datasets are synthetic (data/extreme.py).
"""

import dataclasses

from repro_torch.core.mach import MACHConfig


@dataclasses.dataclass(frozen=True)
class ExtremeTaskConfig:
    name: str
    num_classes: int
    dim: int
    mach_b: int
    mach_r: int
    # reduced CPU-scale stand-in (same B; K, d, R scaled down)
    small_classes: int
    small_dim: int
    small_r: int
    # sparse-feature (bag-of-words) tasks: nonzeros per example; 0 means
    # the task is dense (ImageNet embeddings)
    nnz: int = 0
    small_nnz: int = 0

    @property
    def sparse_features(self) -> bool:
        return self.nnz > 0

    def mach(self, small: bool = False) -> MACHConfig:
        return MACHConfig(
            num_classes=self.small_classes if small else self.num_classes,
            num_buckets=self.mach_b,
            num_repetitions=self.small_r if small else self.mach_r,
            hash_kind="mult_shift" if (self.mach_b & (self.mach_b - 1)) == 0
            else "carter_wegman")

    def sparse_data(self, small: bool = True, noise: float = 0.3,
                    seed: int = 0) -> "SparseExtremeDataConfig":
        """Config for the Zipf-sparse CSR generator (data/extreme.py)
        matching this task's (K, d, nnz) at the chosen scale."""
        from repro_torch.data.extreme import SparseExtremeDataConfig
        if not self.sparse_features:
            raise ValueError(f"{self.name} is a dense-feature task")
        nnz = self.small_nnz if small else self.nnz
        return SparseExtremeDataConfig(
            num_classes=self.small_classes if small else self.num_classes,
            num_features=self.small_dim if small else self.dim,
            nnz=nnz, sig_features=max(1, nnz // 2), noise=noise,
            seed=seed)


# Paper Table 2 run: ODP (B=32, R=25); bag-of-words CSR features
ODP = ExtremeTaskConfig(
    name="odp", num_classes=105033, dim=422713,
    mach_b=32, mach_r=25,
    small_classes=1024, small_dim=256, small_r=12,
    nnz=120, small_nnz=32,
)

# Paper Table 2 run: ImageNet-21k (B=512, R=20)
IMAGENET = ExtremeTaskConfig(
    name="imagenet21k", num_classes=21841, dim=6144,
    mach_b=512, mach_r=20,
    small_classes=1024, small_dim=256, small_r=6,
)

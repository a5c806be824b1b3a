"""Synthetic extreme-classification datasets (ODP / ImageNet-21k stand-ins).

The same generators as the JAX package's ``data/extreme.py``, drawing
from seeded ``torch.Generator``s on the chosen device — they match the
JAX generator in distribution, not number for number (tests feed both
packages the same numpy batches where numbers must agree).

* ``ExtremeDataset`` — class centroids μ_k on the unit sphere,
  x = normalize(μ_y + σ·ε); nearest centroid is Bayes-optimal.
* ``SparseExtremeDataset`` — the ODP bag-of-words regime: each class
  owns ``sig_features`` signature feature ids (value 1), each sample
  carries them plus Zipf-popular background features (value ~
  noise·U[0,1]), L2 normalized, as CSR ``SparseBatch``es.

Sample batches are pure functions of (seed, split, step); class
frequencies are Zipf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device

_SPLITS = {"train": 0, "test": 1}


def _generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded purely from ``key``."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed)


def _zipf(n: int, a: float, device: torch.device) -> torch.Tensor:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-a)
    return torch.as_tensor(w / w.sum(), dtype=torch.float32, device=device)


def _split_id(split: str) -> int:
    try:
        return _SPLITS[split]
    except KeyError:
        raise ValueError(f"split must be train|test, got {split!r}") from None


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """A CSR batch of sparse feature vectors.

    Row n's features are ``indices[indptr[n]:indptr[n+1]]`` with weights
    ``values[...]``; duplicate indices within a row sum on densification.
    ``nnz_max`` bounds the longest row.
    """

    indptr: torch.Tensor     # (N+1,) int32
    indices: torch.Tensor    # (nnz,) int32
    values: torch.Tensor     # (nnz,) float
    num_features: int
    nnz_max: int

    @property
    def num_rows(self) -> int:
        return self.indptr.shape[0] - 1

    def to_dense(self) -> torch.Tensor:
        """(N, d) densification — the materializing path."""
        from repro_torch.kernels.ref import csr_densify_ref  # single source
        return csr_densify_ref(self.indptr, self.indices, self.values,
                               self.num_features)


@dataclasses.dataclass(frozen=True)
class ExtremeDataConfig:
    num_classes: int
    dim: int
    noise: float = 0.5
    seed: int = 0
    zipf_a: float = 1.0          # 0 = uniform class frequencies


class ExtremeDataset:

    def __init__(self, cfg: ExtremeDataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = _generator(self.device, cfg.seed, 0)
        mu = torch.randn((cfg.num_classes, cfg.dim), generator=gen,
                         device=self.device)
        self.centroids = mu / torch.linalg.norm(mu, dim=1, keepdim=True)
        self.class_probs = (_zipf(cfg.num_classes, cfg.zipf_a, self.device)
                            if cfg.zipf_a > 0 else None)

    def _labels(self, gen: torch.Generator, batch_size: int) -> torch.Tensor:
        if self.class_probs is not None:
            return torch.multinomial(self.class_probs, batch_size,
                                     replacement=True, generator=gen)
        return torch.randint(0, self.cfg.num_classes, (batch_size,),
                             generator=gen, device=self.device)

    def batch_at(self, step: int, batch_size: int, split: str = "train"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (x (B, d), y (B,) int32).  Splits draw from disjoint
        streams."""
        cfg = self.cfg
        gen = _generator(self.device, cfg.seed, 1, _split_id(split), step)
        y = self._labels(gen, batch_size)
        eps = torch.randn((batch_size, cfg.dim), generator=gen,
                          device=self.device)
        x = self.centroids[y] + cfg.noise * eps
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        return x, y.to(torch.int32)

    def bayes_predict(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest centroid = Bayes-optimal under isotropic noise
        (ignoring the mild Zipf prior)."""
        return torch.argmax(x @ self.centroids.T, dim=-1).to(torch.int32)

    def bayes_accuracy(self, steps: int = 8, batch_size: int = 512) -> float:
        accs = []
        for s in range(steps):
            x, y = self.batch_at(10_000 + s, batch_size, "test")
            accs.append(float((self.bayes_predict(x) == y).float().mean()))
        return float(np.mean(accs))


@dataclasses.dataclass(frozen=True)
class SparseExtremeDataConfig:
    num_classes: int
    num_features: int            # d — the sparse feature space
    nnz: int = 32                # max nonzeros per example (= nnz_max)
    sig_features: int = 16       # class-signature features per class
    noise: float = 0.3           # value scale of background features
    seed: int = 0
    zipf_a: float = 1.0          # class-frequency Zipf (0 = uniform)
    feature_zipf_a: float = 1.0  # background-feature popularity Zipf
    length_zipf_a: float = 0.0   # doc-length Zipf: 0 = every row has
    #                              exactly nnz entries; > 0 = ragged
    #                              rows, length in [sig_features, nnz]
    #                              with P(len = sig + t) ∝ (1+t)^-a

    def __post_init__(self):
        if not 0 < self.sig_features <= self.nnz:
            raise ValueError("need 0 < sig_features <= nnz")
        if self.length_zipf_a < 0:
            raise ValueError("length_zipf_a must be >= 0")


class SparseExtremeDataset:
    """Zipf-sparse CSR generator (see the module docstring).  With
    ``length_zipf_a > 0`` the background count per row is Zipf-distributed
    (ragged CSR); otherwise every row has exactly ``nnz`` entries."""

    def __init__(self, cfg: SparseExtremeDataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = _generator(self.device, cfg.seed, 2)
        self.signatures = torch.randint(
            0, cfg.num_features, (cfg.num_classes, cfg.sig_features),
            generator=gen, device=self.device)
        self.class_probs = (_zipf(cfg.num_classes, cfg.zipf_a, self.device)
                            if cfg.zipf_a > 0 else None)
        self.feature_probs = _zipf(cfg.num_features,
                                   max(cfg.feature_zipf_a, 0.0), self.device)

    def batch_at(self, step: int, batch_size: int, split: str = "train",
                 format: str = "csr"):
        """Returns (SparseBatch, y (B,) int32) — or the exact
        densification (x (B, d), y) with ``format="dense"``."""
        if format not in ("csr", "dense"):
            raise ValueError(f"format must be csr|dense, got {format!r}")
        cfg = self.cfg
        dev = self.device
        gen = _generator(dev, cfg.seed, 3, _split_id(split), step)
        if self.class_probs is not None:
            y = torch.multinomial(self.class_probs, batch_size,
                                  replacement=True, generator=gen)
        else:
            y = torch.randint(0, cfg.num_classes, (batch_size,),
                              generator=gen, device=dev)
        n_bg = cfg.nnz - cfg.sig_features
        ids = self.signatures[y]                                  # (B, sig)
        vals = torch.ones((batch_size, cfg.sig_features), device=dev)
        if n_bg:
            bg_ids = torch.multinomial(self.feature_probs, batch_size * n_bg,
                                       replacement=True, generator=gen)
            bg_vals = cfg.noise * torch.rand((batch_size, n_bg),
                                             generator=gen, device=dev)
            ids = torch.cat([ids, bg_ids.reshape(batch_size, n_bg)], dim=1)
            vals = torch.cat([vals, bg_vals], dim=1)
        if cfg.length_zipf_a > 0:
            t = torch.arange(n_bg + 1, dtype=torch.float32, device=dev)
            extra = torch.multinomial(
                torch.softmax(-cfg.length_zipf_a * torch.log1p(t), dim=0),
                batch_size, replacement=True, generator=gen)
            keep = cfg.sig_features + extra                       # (B,)
            mask = torch.arange(cfg.nnz, device=dev)[None, :] < keep[:, None]
            vals = torch.where(mask, vals, 0.0)
            vals = vals / torch.linalg.norm(vals, dim=1, keepdim=True)
            indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                                torch.cumsum(keep, 0)])
            indices, values = ids[mask], vals[mask]
        else:
            vals = vals / torch.linalg.norm(vals, dim=1, keepdim=True)
            indptr = torch.arange(batch_size + 1, device=dev) * cfg.nnz
            indices, values = ids.reshape(-1), vals.reshape(-1)
        batch = SparseBatch(indptr=indptr.to(torch.int32),
                            indices=indices.to(torch.int32), values=values,
                            num_features=cfg.num_features, nnz_max=cfg.nnz)
        y = y.to(torch.int32)
        if format == "dense":
            return batch.to_dense(), y
        return batch, y

"""MACH — Merged-Averaged Classifiers via Hashing (the paper's algorithm).

* ``mach_loss``       — R-head cross-entropy on hashed labels
                        (Algorithm 1's trainLogistic target transform).
* ``MACHLinear``      — the paper-faithful model: R independent B-way
                        logistic regressions over raw features (dense or
                        CSR-sparse); ``fused=True`` trains through the
                        logit-free fused loss.
* ``MACHOutputHead``  — drop-in replacement for an LM's d×V softmax head,
                        producing (…, R, B) logits with O(d·R·B) params.

Both heads implement ``MACHHead``.  Parameters are plain dicts of
tensors, with the same keys and layouts as the JAX package's params
(``convert.py`` carries them across), so both packages compute the same
thing on the same weights.  Prediction (Algorithm 2) lives in
``estimators.py`` (reference) and ``kernels/`` (CUDA decode kernels);
``fused_loss`` runs the fused projection + CE kernels
(``kernels/mach_fused_xent.py``), which never form the logits.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import estimators as est
from repro_torch.core import hashing


@dataclasses.dataclass(frozen=True)
class MACHConfig:
    """Static configuration of a MACH classifier/head.

    B and R are the paper's two knobs (memory BRd, inference RBd + KR).
    """

    num_classes: int            # K
    num_buckets: int            # B
    num_repetitions: int        # R
    seed: int = 0
    estimator: str = "unbiased"         # unbiased | min | median
    hash_kind: str = "auto"             # auto | carter_wegman | mult_shift

    def __post_init__(self):
        if self.num_buckets < 2:
            raise ValueError("B must be >= 2")
        if self.num_repetitions < 1:
            raise ValueError("R must be >= 1")
        if self.estimator not in est.ESTIMATORS:
            raise ValueError(f"estimator {self.estimator!r} not in {est.ESTIMATORS}")
        if self.hash_kind not in hashing.HASH_KINDS:
            raise ValueError(f"hash_kind {self.hash_kind!r} not in "
                             f"{hashing.HASH_KINDS}")

    @property
    def family(self):
        return hashing.make_hash_family(
            self.num_buckets, self.num_repetitions, self.seed, self.hash_kind)

    def table(self, device=None) -> torch.Tensor:
        """(R, K) int32 bucket table on ``device`` (default ``cuda``)."""
        return self.family.table(self.num_classes, device)

    def table_np(self) -> np.ndarray:
        return self.family.table_np(self.num_classes)

    def hash_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """(...,) class ids -> (R, ...) bucket ids on ``labels``' device."""
        return self.family.hash_labels(labels, self.num_classes)

    def inverted_table_np(self, pad_to: int = 128) -> np.ndarray:
        """(R·B, L) bucket -> class lists for candidate-filtered decode."""
        return hashing.inverted_table_np(self.table_np(), self.num_buckets,
                                         pad_to)

    def inverted_table(self, pad_to: int = 128, device=None) -> torch.Tensor:
        """The (R·B, L) int32 inverted table on ``device`` (default ``cuda``)."""
        return hashing.inverted_table(self.table_np(), self.num_buckets,
                                      pad_to, device)

    # --- theory (paper §3.1) ---
    def indistinguishable_bound(self) -> float:
        return hashing.indistinguishable_pair_bound(
            self.num_classes, self.num_buckets, self.num_repetitions)

    def memory_reduction(self) -> float:
        return hashing.memory_reduction(
            self.num_classes, self.num_buckets, self.num_repetitions)

    @staticmethod
    def from_delta(num_classes: int, num_buckets: int, delta: float = 1e-3,
                   **kw) -> "MACHConfig":
        """Build a config with R chosen by Theorem 2."""
        r = hashing.r_required(num_classes, num_buckets, delta)
        return MACHConfig(num_classes, num_buckets, r, **kw)


# ---------------------------------------------------------------------------
# Loss: R independent B-way cross entropies on hashed labels.
# ---------------------------------------------------------------------------

def mach_loss(logits: torch.Tensor, hashed_labels: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean (over batch) of the summed R-head cross-entropy.

    logits:        (..., R, B)
    hashed_labels: (R, ...)  bucket ids — leading R (hash-family layout)
    weights:       (...,) optional 0/1 mask (e.g. padding tokens)
    """
    r = logits.shape[-2]
    if hashed_labels.shape[0] != r:
        raise ValueError(f"R mismatch: logits {tuple(logits.shape)}, labels "
                         f"{tuple(hashed_labels.shape)}")
    logp = torch.log_softmax(logits, dim=-1)
    lbl = hashed_labels.movedim(0, -1).long()                 # (..., R)
    picked = torch.gather(logp, -1, lbl[..., None])[..., 0]   # (..., R)
    return _weighted_mean(-picked.sum(dim=-1), weights)


def _weighted_mean(nll: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean per-example loss, optionally masked (all-zero weights -> 0)."""
    if weights is not None:
        return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    return nll.mean()


def is_sparse_batch(x: Any) -> bool:
    """Duck-typed CSR batch check (``data.extreme.SparseBatch`` or any
    object with indptr/indices/values)."""
    return hasattr(x, "indptr") and hasattr(x, "indices") \
        and hasattr(x, "values")


def mach_meta_probs(logits: torch.Tensor) -> torch.Tensor:
    """(..., R, B) logits -> (R, ..., B) per-head probabilities P^j."""
    return torch.softmax(logits, dim=-1).movedim(-2, 0)


# ---------------------------------------------------------------------------
# The shared head abstraction.
# ---------------------------------------------------------------------------

class MACHHead(abc.ABC):
    """Abstract base for trainable MACH heads.

    Implementations provide ``init`` / ``head_logits`` / ``fused_loss``
    / ``param_count``; the base derives ``loss``, ``meta_probs``,
    ``predict`` and ``class_probs`` from ``head_logits``.  The (R, K)
    table is built once per device and kept on the head.
    """

    cfg: MACHConfig

    @abc.abstractmethod
    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        ...

    @abc.abstractmethod
    def head_logits(self, params: dict, inputs: Any) -> torch.Tensor:
        """inputs -> (..., R, B) per-head bucket logits."""

    @abc.abstractmethod
    def fused_loss(self, params: dict, inputs: Any, labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   bucket_select: Optional[tuple] = None,
                   bucket_proxy: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logit-free counterpart of ``loss`` (fused projection + CE):
        the same value and gradients, without the (…, R, B) logits.

        ``bucket_select=(c_sel, refresh_every)`` turns on dynamic bucket
        selection: the fused loss runs over the top-``c_sel``
        proxy-scored bucket columns of each repetition, label buckets
        force-included (a one-sided, bounded bias; see
        ``ops.mach_fused_xent``).  ``bucket_proxy`` passes cached (R, B)
        proxy scores (``train.Trainer`` refreshes them every
        ``refresh_every`` steps through ``bucket_proxy_scores``)."""

    def bucket_proxy_scores(self, params: dict, inputs: Any) -> torch.Tensor:
        """(R, B) proxy scores for dynamic bucket selection: the logits of
        the batch-mean activation, one d·R·B matvec, cacheable across
        steps."""
        raise NotImplementedError

    @abc.abstractmethod
    def param_count(self) -> int:
        ...

    def table(self, device) -> torch.Tensor:
        """The config's (R, K) table on ``device``, built on first use."""
        return self._cached("_tables", device, self.cfg.table)

    def inverted_table(self, device) -> torch.Tensor:
        """The config's (R·B, L) inverted table on ``device``, built on
        first use (candidate-filtered decode)."""
        return self._cached("_inverted", device, self.cfg.inverted_table)

    def _cached(self, slot: str, device, build) -> torch.Tensor:
        device = torch.device(device)
        cache = self.__dict__.setdefault(slot, {})
        if device not in cache:
            cache[device] = build(device=device)
        return cache[device]

    def loss(self, params: dict, inputs: Any, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return mach_loss(self.head_logits(params, inputs),
                         self.cfg.hash_labels(labels), weights)

    def meta_probs(self, params: dict, inputs: Any) -> torch.Tensor:
        """getProbability of Algorithm 2: (R, ..., B)."""
        return mach_meta_probs(self.head_logits(params, inputs))

    def predict(self, params: dict, inputs: Any,
                estimator: Optional[str] = None, candidate_mode=None,
                inverted: Optional[torch.Tensor] = None) -> torch.Tensor:
        """argmax-class prediction (Algorithm 2).

        ``candidate_mode``: None | "exact" score all K classes; an
        (m, t) tuple routes through the count-min candidate filter
        (``predict_topk`` with k=1), whose cost is independent of K.
        ``inverted`` defaults to the head's cached inverted table.
        """
        name = estimator or self.cfg.estimator
        meta = self.meta_probs(params, inputs)
        table = self.table(meta.device)
        if candidate_mode is not None and candidate_mode != "exact":
            if inverted is None:
                inverted = self.inverted_table(meta.device)
            _, idx = est.predict_topk(meta, table, 1, name,
                                      candidate_mode=candidate_mode,
                                      inverted=inverted)
            return idx[..., 0]
        return est.predict_classes(meta, table, name)

    def class_probs(self, params: dict, inputs: Any,
                    estimator: Optional[str] = None) -> torch.Tensor:
        meta = self.meta_probs(params, inputs)
        return est.estimate_class_probs(meta, self.table(meta.device),
                                        estimator or self.cfg.estimator)


def _normal(shape, generator, device) -> torch.Tensor:
    """N(0, 1) draws from ``generator`` (on its own device), moved to
    ``device``."""
    gdev = generator.device if generator is not None else torch.device("cpu")
    return torch.randn(shape, generator=generator, device=gdev,
                       dtype=torch.float32).to(device)


class MACHLinear(MACHHead):
    """R B-way logistic regressions on d features — the paper's §4 model.

    Parameters: w (d, R, B), b (R, B) — total d·R·B + R·B.  Inputs may
    be dense (n, d) tensors or CSR ``SparseBatch``es (the ODP
    bag-of-words regime).  ``head_logits`` densifies a CSR batch; with
    ``fused=True``, ``loss`` runs the fused logit-free kernels on it as
    it is.
    """

    def __init__(self, cfg: MACHConfig, dim: int, fused: bool = False):
        self.cfg = cfg
        self.dim = dim
        self.fused = fused

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        """Random weights drawn from ``generator`` (a CUDA generator draws
        on the card), zero bias."""
        device = resolve_device(device)
        c = self.cfg
        scale = 1.0 / math.sqrt(self.dim)
        w = _normal((self.dim, c.num_repetitions, c.num_buckets),
                    generator, device)
        return {"w": w.mul_(scale),
                "b": torch.zeros((c.num_repetitions, c.num_buckets),
                                 dtype=torch.float32, device=device)}

    def head_logits(self, params: dict, x: Any) -> torch.Tensor:
        """(n, d) dense or CSR SparseBatch -> (n, R, B)."""
        if is_sparse_batch(x):
            x = x.to_dense()          # materializing path
        w = params["w"]
        out = torch.matmul(x, w.reshape(self.dim, -1))
        return out.reshape(x.shape[:-1] + w.shape[1:]) + params["b"]

    # the name before MACHHead
    def logits(self, params: dict, x: Any) -> torch.Tensor:
        return self.head_logits(params, x)

    def loss(self, params: dict, x: Any, y: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Routes through the fused logit-free path when ``fused=True``
        (same value and gradients), else materializes the (n, R, B)
        logits."""
        if self.fused:
            return self.fused_loss(params, x, y, weights)
        return super().loss(params, x, y, weights)

    def fused_loss(self, params: dict, x: Any, y: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   bucket_select: Optional[tuple] = None,
                   bucket_proxy: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logit-free loss via ``ops.mach_fused_xent`` (dense x) or
        ``ops.mach_fused_xent_csr`` (SparseBatch x), the bias a native
        kernel operand on both."""
        from repro_torch.kernels import ops  # deferred: kernels import core
        c = self.cfg
        hashed = c.hash_labels(y).movedim(0, -1)             # (n, R)
        w2 = params["w"].reshape(self.dim, -1)               # (d, R·B)
        bias = params["b"].reshape(-1)                       # (R·B,)
        if is_sparse_batch(x):
            nll = ops.mach_fused_xent_csr(
                x.indptr, x.indices, x.values, w2, hashed,
                num_buckets=c.num_buckets, nnz_max=x.nnz_max, bias=bias,
                bucket_select=bucket_select, bucket_proxy=bucket_proxy)
        else:
            nll = ops.mach_fused_xent(
                x, w2, hashed, num_buckets=c.num_buckets, bias=bias,
                bucket_select=bucket_select, bucket_proxy=bucket_proxy)
        return _weighted_mean(nll, weights)

    def bucket_proxy_scores(self, params: dict, x: Any) -> torch.Tensor:
        """(R, B) proxy from a dense or CSR batch (the CSR mean is a
        scatter-add, never a densified batch)."""
        from repro_torch.kernels import ops  # deferred: kernels import core
        w2 = params["w"].reshape(self.dim, -1)
        bias = params["b"].reshape(-1)
        if is_sparse_batch(x):
            return ops.mach_bucket_proxy(
                w=w2, num_buckets=self.cfg.num_buckets, bias=bias,
                csr=(x.indptr, x.indices, x.values))
        return ops.mach_bucket_proxy(x, w2, num_buckets=self.cfg.num_buckets,
                                     bias=bias)

    def param_count(self) -> int:
        c = self.cfg
        return self.dim * c.num_repetitions * c.num_buckets \
            + c.num_repetitions * c.num_buckets

    # --- embarrassing parallelism (paper §6.1): per-repetition slices ---
    @staticmethod
    def slice_repetition(params: dict, j: int) -> dict:
        """Extract repetition j's independent model (train anywhere)."""
        return {"w": params["w"][:, j], "b": params["b"][j]}

    @staticmethod
    def merge_repetitions(slices: list[dict]) -> dict:
        """Inverse of slice_repetition — merge R separately-trained models."""
        return {
            "w": torch.stack([s["w"] for s in slices], dim=1),
            "b": torch.stack([s["b"] for s in slices], dim=0),
        }


class MACHOutputHead(MACHHead):
    """Drop-in replacement for an LM's unembedding: d -> (R, B) logits.

    The kernel is stored as (d, R*B) so the forward pass is one matmul;
    logits are reshaped to (..., R, B).
    """

    def __init__(self, cfg: MACHConfig, dim: int, dtype=torch.float32):
        self.cfg = cfg
        self.dim = dim
        self.dtype = dtype

    @property
    def out_features(self) -> int:
        return self.cfg.num_repetitions * self.cfg.num_buckets

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        device = resolve_device(device)
        scale = 1.0 / math.sqrt(self.dim)
        k = _normal((self.dim, self.out_features), generator, device)
        return {"kernel": (k * scale).to(self.dtype)}

    def apply(self, params: dict, h: torch.Tensor,
              reps: Optional[tuple] = None) -> torch.Tensor:
        """(..., d) hidden states -> (..., R, B) logits.  With ``reps`` =
        (r0, r1) the kernel holds only those repetitions' columns (a
        rank's shard of a head split by repetition, ``sharding.
        repetition_range``) and the logits are (..., r1 − r0, B)."""
        out = h @ params["kernel"].to(h.dtype)
        r = self.cfg.num_repetitions if reps is None else reps[1] - reps[0]
        return out.reshape(out.shape[:-1] + (r, self.cfg.num_buckets))

    def head_logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        return self.apply(params, h)

    def fused_loss(self, params: dict, h: torch.Tensor, labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   bucket_select: Optional[tuple] = None,
                   bucket_proxy: Optional[torch.Tensor] = None,
                   reps: Optional[tuple] = None) -> torch.Tensor:
        """Logit-free counterpart of ``loss``: the projection is fused
        into the hashed cross-entropy (``ops.mach_fused_xent``), so the
        (…, R, B) logits never exist; gradients reach h and the kernel.
        ``bucket_select`` / ``bucket_proxy`` as on ``MACHHead.fused_loss``;
        ``reps`` as on ``apply`` (the loss of those repetitions, on the
        hashed labels' rows [r0, r1))."""
        from repro_torch.kernels import ops  # deferred: kernels import core
        hashed = self.cfg.hash_labels(labels)
        if reps is not None:
            hashed = hashed[reps[0]:reps[1]]
        hashed = hashed.movedim(0, -1)
        nll = ops.mach_fused_xent(h, params["kernel"], hashed,
                                  num_buckets=self.cfg.num_buckets,
                                  bucket_select=bucket_select,
                                  bucket_proxy=bucket_proxy)
        return _weighted_mean(nll, weights)

    def bucket_proxy_scores(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """(R, B) proxy from hidden states (..., d)."""
        from repro_torch.kernels import ops  # deferred: kernels import core
        return ops.mach_bucket_proxy(h, params["kernel"],
                                     num_buckets=self.cfg.num_buckets)

    def param_count(self) -> int:
        return self.dim * self.out_features

    def full_softmax_param_count(self) -> int:
        return self.dim * self.cfg.num_classes

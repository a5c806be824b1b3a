"""2-universal hashing for MACH (paper §2.1).

Two constructions, bit-exact with the JAX package's:

1. ``CarterWegmanFamily`` — h(x) = ((a·x + b) mod p) mod B with p the
   Mersenne prime 2^61 − 1.  Tables are materialized host-side with
   numpy 64-bit integer arithmetic (exact for K < 2^31) and moved to the
   device as an (R, K) int32 tensor; label hashing is a table gather.
2. ``MultShiftFamily`` — a random odd a ∈ [2^32], h(x) = (a·x mod 2^32)
   >> (32 − log2 B).  B must be a power of two.  Cheap enough to
   evaluate inside the decode kernels, which then read no hash table.

Both expose ``coeffs()`` and ``table_np(K)`` (numpy), ``table(K,
device)`` ((R, K) int32 tensor) and ``hash_labels(y)`` ((R, *y.shape)
bucket ids on ``y``'s device).  Torch has no general uint32 arithmetic,
so multiply-shift runs in int64 masked with ``0xFFFFFFFF``: a < 2^32 and
y < 2^31 keep the product below 2^63.

Theory helpers implement Theorem 2 / Eq. 6 of the paper.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import resolve_device

MERSENNE_P = (1 << 61) - 1  # prime > any realistic K
_MASK32 = 0xFFFFFFFF


def r_required(num_classes: int, num_buckets: int, delta: float = 1e-3) -> int:
    """Theorem 2: smallest R s.t. all class pairs are distinguishable
    with probability >= 1 - delta:  R = 2 log(K / sqrt(delta)) / log B.
    """
    if num_buckets < 2:
        raise ValueError("need B >= 2")
    r = 2.0 * math.log(num_classes / math.sqrt(delta)) / math.log(num_buckets)
    return max(1, int(math.ceil(r)))


def indistinguishable_pair_bound(num_classes: int, num_buckets: int,
                                 num_repetitions: int) -> float:
    """Union bound (Eq. 6): P(∃ indistinguishable pair) <= K^2 · B^-R."""
    log_p = 2.0 * math.log(num_classes) - num_repetitions * math.log(num_buckets)
    return min(1.0, math.exp(log_p))


def memory_reduction(num_classes: int, num_buckets: int,
                     num_repetitions: int) -> float:
    """Model-size ratio O(Kd) / O(BRd) (ODP B=32, R=25 → ≈ 131x)."""
    return num_classes / float(num_buckets * num_repetitions)


@dataclasses.dataclass(frozen=True)
class CarterWegmanFamily:
    """R independent exactly-2-universal hash functions [K] -> [B]."""

    num_buckets: int
    num_repetitions: int
    seed: int = 0

    def coeffs(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0xC33]))
        a = rng.integers(1, MERSENNE_P, size=self.num_repetitions, dtype=np.uint64)
        b = rng.integers(0, MERSENNE_P, size=self.num_repetitions, dtype=np.uint64)
        return a, b

    def table_np(self, num_classes: int) -> np.ndarray:
        a, b = self.coeffs()
        k = np.arange(num_classes, dtype=np.uint64)
        rows = []
        for j in range(self.num_repetitions):
            aj, bj = int(a[j]), int(b[j])
            # exact: split a into 30-bit limbs so products fit in uint64
            a_lo, a_hi = aj & ((1 << 30) - 1), aj >> 30
            lo = (a_lo * k) % MERSENNE_P
            hi = (a_hi % MERSENNE_P) * (k % MERSENNE_P) % MERSENNE_P
            hi = (hi * ((1 << 30) % MERSENNE_P)) % MERSENNE_P
            h = (lo + hi + bj) % MERSENNE_P
            rows.append((h % self.num_buckets).astype(np.int32))
        return np.stack(rows, axis=0)

    def table(self, num_classes: int, device=None) -> torch.Tensor:
        return torch.from_numpy(self.table_np(num_classes)).to(
            resolve_device(device))

    def hash_labels(self, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
        """(...,) int labels -> (R, ...) bucket ids via exact table gather."""
        tab = self.table(num_classes, labels.device)         # (R, K)
        return tab[:, labels.long()]


@dataclasses.dataclass(frozen=True)
class MultShiftFamily:
    """Multiply-shift hashing (paper §2.1 'fastest way'); B must be 2^k.

    h_j(x) = (a_j * x mod 2^32) >> (32 - log2 B), a_j random odd uint32.
    """

    num_buckets: int
    num_repetitions: int
    seed: int = 0

    def __post_init__(self):
        if self.num_buckets & (self.num_buckets - 1):
            raise ValueError("MultShiftFamily requires power-of-two B")
        if self.num_buckets < 2:
            raise ValueError("need B >= 2")

    @property
    def shift(self) -> int:
        return 32 - int(math.log2(self.num_buckets))

    def coeffs(self) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0x5F7]))
        a = rng.integers(0, 1 << 31, size=self.num_repetitions,
                         dtype=np.uint32).astype(np.uint32) * np.uint32(2) + np.uint32(1)
        return a

    def coeffs_tensor(self, device=None) -> torch.Tensor:
        """(R,) int64 coefficients — the decode kernels' inline-hash operand."""
        return torch.from_numpy(self.coeffs().astype(np.int64)).to(
            resolve_device(device))

    def table_np(self, num_classes: int) -> np.ndarray:
        a = self.coeffs().astype(np.uint64)
        k = np.arange(num_classes, dtype=np.uint64)
        prod = (a[:, None] * k[None, :]) & np.uint64(0xFFFFFFFF)
        return (prod >> np.uint64(self.shift)).astype(np.int32)

    def table(self, num_classes: int, device=None) -> torch.Tensor:
        return torch.from_numpy(self.table_np(num_classes)).to(
            resolve_device(device))

    def hash_labels(self, labels: torch.Tensor, num_classes: int = 0) -> torch.Tensor:
        """On-the-fly hashing on ``labels``' device: (...,) -> (R, ...)."""
        a = self.coeffs_tensor(labels.device)
        y = labels.long() & _MASK32
        prod = (a.reshape((-1,) + (1,) * y.dim()) * y[None]) & _MASK32
        return (prod >> self.shift).to(torch.int32)


def inverted_table_np(table: np.ndarray, num_buckets: int,
                      pad_to: int = 128) -> np.ndarray:
    """Invert an (R, K) bucket table into (R·B, L) class lists.

    Row ``j*B + b`` lists, in ascending class id, every class c with
    ``table[j, c] == b``, padded with the sentinel ``K`` to L = the max
    bucket occupancy rounded up to ``pad_to``.
    """
    table = np.asarray(table)
    if table.ndim != 2:
        raise ValueError(f"table must be (R, K), got {table.shape}")
    r, k = table.shape
    b = num_buckets
    if table.size and (table.min() < 0 or table.max() >= b):
        raise ValueError("table entries out of range for num_buckets")
    counts = np.zeros((r, b), dtype=np.int64)
    for j in range(r):
        counts[j] = np.bincount(table[j], minlength=b)
    occ = int(counts.max()) if counts.size else 0
    ell = max(pad_to, -(-occ // pad_to) * pad_to)
    inv = np.full((r * b, ell), k, dtype=np.int32)
    cls = np.arange(k, dtype=np.int64)
    for j in range(r):
        # stable sort by bucket keeps each bucket's classes ascending
        order = np.argsort(table[j], kind="stable")
        starts = np.searchsorted(table[j][order], np.arange(b))
        pos = cls - starts[table[j][order]]  # slot within its bucket
        inv[j * b + table[j][order], pos] = order
    return inv


def inverted_table(table, num_buckets: int, pad_to: int = 128,
                   device=None) -> torch.Tensor:
    """(R·B, L) int32 inverted table (see ``inverted_table_np``) on
    ``device`` (default ``cuda``); ``table`` is an (R, K) array or tensor."""
    if isinstance(table, torch.Tensor):
        table = table.cpu().numpy()
    return torch.from_numpy(inverted_table_np(table, num_buckets, pad_to)).to(
        resolve_device(device))


# the known hash-family kinds — ``MACHConfig`` validates against this
HASH_KINDS = ("auto", "carter_wegman", "mult_shift")


def make_hash_family(num_buckets: int, num_repetitions: int, seed: int = 0,
                     kind: str = "auto"):
    """kind: 'auto' (mult_shift when B=2^k else carter_wegman) |
    'carter_wegman' | 'mult_shift'."""
    if kind not in HASH_KINDS:
        raise ValueError(f"unknown hash family kind: {kind!r} "
                         f"(known: {HASH_KINDS})")
    if kind == "auto":
        kind = ("mult_shift"
                if num_buckets & (num_buckets - 1) == 0 else "carter_wegman")
    if kind == "mult_shift":
        return MultShiftFamily(num_buckets, num_repetitions, seed)
    return CarterWegmanFamily(num_buckets, num_repetitions, seed)

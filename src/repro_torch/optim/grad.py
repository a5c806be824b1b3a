"""Gradient utilities: value-and-grad, global-norm clipping,
microbatch accumulation, compression.

Gradient compression is the JAX package's (``repro/optim/grad.py``),
for slow links between hosts:

* ``topk_compress`` — per-leaf magnitude top-k sparsification with
  error feedback (the residual is carried into the next step's
  gradient, Stich et al. 2018);
* ``quantize_8bit`` / ``dequantize_8bit`` — per-leaf absmax int8.

As in the JAX package, no train step calls them.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.optim.optimizers import _unflatten, tree_leaves, tree_map


def value_and_grad(loss_fn, params, *args, has_aux: bool = False):
    """``jax.value_and_grad`` for a function of a tree of tensors:
    returns (loss_fn(params, *args), grads shaped like params).  The
    gradient is taken at detached copies of the leaves, so ``params``
    need not require grad.  A ``DTensor`` leaf's gradient comes back on
    its own placements (``sharding.materialize``'s backward); one that
    does not raises.  With ``has_aux`` loss_fn returns (loss, aux) and
    the first result is that pair."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    out = loss_fn(leaves, *args)
    loss = out[0] if has_aux else out
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat)
    for p, g in zip(flat, grads):
        if isinstance(p, DTensor) and (not isinstance(g, DTensor) or
                                       g.placements != p.placements):
            raise ValueError(f"a gradient came back on "
                             f"{getattr(g, 'placements', 'no mesh')}, its "
                             f"param lies on {p.placements}")
    grads = iter(grads)
    g_tree = tree_map(lambda _: next(grads), leaves)
    if has_aux:
        return (loss.detach(), tree_map(torch.Tensor.detach, out[1])), g_tree
    return loss.detach(), g_tree


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global norm is at most ``max_norm``.
    Returns (clipped grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def accumulate_grads(loss_fn, params, batch, num_microbatches: int):
    """Split the batch's leading dim into microbatches, take each one's
    gradient and average.  ``loss_fn(params, batch) -> (loss, metrics)``
    (metrics a tree of tensors).  Returns ((loss, metrics), grads).  The
    float32 sums take each param's placements (a ``DTensor`` param's
    are sharded like it, never whole)."""
    if num_microbatches <= 1:
        return value_and_grad(loss_fn, params, batch, has_aux=True)

    def split(x):
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{num_microbatches} microbatches")
        return x.reshape((num_microbatches, b // num_microbatches)
                         + tuple(x.shape[1:]))

    micro = tree_map(split, batch)
    g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    loss_acc, metr_acc = 0.0, None
    for i in range(num_microbatches):
        (loss, metrics), g = value_and_grad(
            loss_fn, params, tree_map(lambda x: x[i], micro), has_aux=True)
        g_acc = tree_map(lambda a, b: a + b.to(torch.float32), g_acc, g)
        loss_acc = loss_acc + loss
        metr_acc = metrics if metr_acc is None else \
            tree_map(lambda a, b: a + b, metr_acc, metrics)
    n = float(num_microbatches)
    return ((loss_acc / n, tree_map(lambda x: x / n, metr_acc)),
            tree_map(lambda x: x / n, g_acc))


# ---------------------------------------------------------------------------
# Top-k sparsification with error feedback
# ---------------------------------------------------------------------------

class ErrorFeedbackState(NamedTuple):
    residual: Any


def init_error_feedback(params) -> ErrorFeedbackState:
    return ErrorFeedbackState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def topk_compress(grads, ef: ErrorFeedbackState, fraction: float = 0.01):
    """Keep each leaf's top ``fraction`` of entries by magnitude (at least
    one); the rest goes into the error-feedback residual.  The threshold
    is the k-th largest |g|, and every entry at it is kept, ties too.
    Returns (kept grads, float32; the new ``ErrorFeedbackState``)."""

    def per_leaf(g, r):
        g = g.to(torch.float32) + r
        flat = g.reshape(-1)
        k = max(1, int(flat.numel() * fraction))
        thresh = torch.topk(flat.abs(), k).values[-1]
        kept = torch.where(g.abs() >= thresh, g, 0.0)
        return kept, g - kept

    outs = [per_leaf(g, r) for g, r in zip(tree_leaves(grads),
                                           tree_leaves(ef.residual))]
    return (_unflatten(grads, [o[0] for o in outs]),
            ErrorFeedbackState(_unflatten(grads, [o[1] for o in outs])))


# ---------------------------------------------------------------------------
# 8-bit absmax quantization
# ---------------------------------------------------------------------------

class Quantized(NamedTuple):
    q: Any        # int8 payloads
    scale: Any    # float32 per-leaf absmax scales


def quantize_8bit(grads) -> Quantized:
    """Each leaf as int8 ``round(g / s)`` (half to even, as ``jnp.round``)
    with ``s = max(max|g|, 1e-12) / 127``."""
    def per_leaf(g):
        g = g.to(torch.float32)
        # divided by a tensor on g's device: PyTorch's CUDA kernels divide
        # by a Python number as a product with its reciprocal, one ulp
        # away from a division now and then
        s = torch.clamp(g.abs().max(), min=1e-12) / g.new_tensor(127.0)
        return torch.clamp(torch.round(g / s), -127, 127).to(torch.int8), s

    outs = [per_leaf(g) for g in tree_leaves(grads)]
    return Quantized(_unflatten(grads, [o[0] for o in outs]),
                     _unflatten(grads, [o[1] for o in outs]))


def dequantize_8bit(qt: Quantized):
    return tree_map(lambda q, s: q.to(torch.float32) * s, qt.q, qt.scale)

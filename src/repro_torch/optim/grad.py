"""Gradient utilities: value-and-grad, global-norm clipping,
microbatch accumulation."""

from __future__ import annotations

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map


def value_and_grad(loss_fn, params, *args, has_aux: bool = False):
    """``jax.value_and_grad`` for a function of a tree of tensors:
    returns (loss_fn(params, *args), grads shaped like params).  The
    gradient is taken at detached copies of the leaves, so ``params``
    need not require grad.  With ``has_aux`` loss_fn returns (loss, aux)
    and the first result is that pair."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    out = loss_fn(leaves, *args)
    loss = out[0] if has_aux else out
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat))
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
    (metrics a tree of tensors).  Returns ((loss, metrics), grads)."""
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
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
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

"""Optimizers on dicts of tensors, in the JAX package's
(init_fn, update_fn) style, with its names and defaults:

    opt = adamw(lr_schedule, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Also ``adafactor``, ``with_master_weights`` (float32 masters for bf16
params) and ``make_optimizer``.  Not ``torch.optim``: its AdamW defaults
(b2 = 0.999, weight decay on every tensor) differ.  The moments are
updated in place, so an optimizer state is consumed by ``update`` (it
saves two copies of the parameters' size: 2.7 GB at ODP's 338 M
parameters); updates and parameters are returned as new tensors.  A
step count is a Python int.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

Schedule = Callable[[Any], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts / lists /
    tuples / NamedTuples (``rest`` shaped like ``tree``); None stays
    None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = (tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree))
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _lr(lr: ScalarOrSchedule, count: int) -> torch.Tensor:
    return lr(count) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# SGD (+ momentum)
# ---------------------------------------------------------------------------

class SGDState(NamedTuple):
    count: int
    momentum: Any


def sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        mom = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params) if momentum else None)
        return SGDState(0, mom)

    def update(grads, state, params=None):
        step_lr = _lr(lr, state.count)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                           state.momentum, grads)
            if nesterov:
                upd = tree_map(lambda m, g: -(step_lr * (momentum * m + g)),
                               mom, grads)
            else:
                upd = tree_map(lambda m: -step_lr * m, mom)
        else:
            mom = None
            upd = tree_map(lambda g: -step_lr * g, grads)
        return upd, SGDState(state.count + 1, mom)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          mask: Optional[Callable[[Any], Any]] = None) -> Optimizer:
    """AdamW with decoupled weight decay.

    mask(params) -> tree of bools selecting decayed leaves (default:
    decay everything with ndim >= 2, i.e. skip norms and biases).
    """
    def default_mask(params):
        return tree_map(lambda p: p.dim() >= 2, params)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params))

    def update(grads, state, params):
        count = state.count + 1
        step_lr = _lr(lr, state.count)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        c1 = 1.0 - f32(b1) ** count
        c2 = 1.0 - f32(b2) ** count
        decay_mask = (mask or default_mask)(params)

        def moments(m, v, g):
            g = g.to(torch.float32)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            return m

        def upd(m, v, p, dm):
            u = (m / c1).div_((v / c2).sqrt_().add_(eps))
            if weight_decay and dm:
                u.add_(p.to(torch.float32), alpha=weight_decay)
            return u.mul_(-step_lr)

        tree_map(moments, state.mu, state.nu, grads)
        updates = tree_map(upd, state.mu, state.nu, params, decay_mask)
        return updates, AdamState(count, state.mu, state.nu)

    return Optimizer(init, update)


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1, b2, eps, weight_decay=0.0)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    count: int
    vr: Any      # row factors (or the full v for leaves under 2-D)
    vc: Any      # column factors (empty for leaves under 2-D)


def _unflatten(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def adafactor(lr: ScalarOrSchedule, eps: float = 1e-30,
              clip_threshold: float = 1.0, decay_rate: float = 0.8
              ) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018), no first moment; the second
    moment factored over the last two dims of leaves with 2 or more —
    O(n + m) optimizer memory, not O(n·m).  Float32 state."""

    def init(params):
        def rows(p):
            shape = p.shape[:-1] if p.dim() >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def cols(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else (0,)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(0, tree_map(rows, params), tree_map(cols, params))

    def update(grads, state, params=None):
        count = state.count + 1
        beta = 1.0 - torch.tensor(count, dtype=torch.float32) ** (-decay_rate)
        step_lr = _lr(lr, state.count)

        def upd(g, vr, vc):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if g.dim() >= 2:
                nvr = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
                nvc = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
                r = nvr / torch.clamp(torch.mean(nvr, dim=-1, keepdim=True),
                                      min=eps)
                v = r[..., None] * nvc[..., None, :]
            else:
                nvr = beta * vr + (1 - beta) * g2
                nvc = vc
                v = nvr
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -step_lr * u, nvr, nvc

        out = [upd(g, vr, vc) for g, vr, vc in zip(
            tree_leaves(grads), tree_leaves(state.vr), tree_leaves(state.vc))]
        return (_unflatten(grads, [o[0] for o in out]),
                AdafactorState(count, _unflatten(grads, [o[1] for o in out]),
                               _unflatten(grads, [o[2] for o in out])))

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Mixed precision: float32 master weights for bf16 params
# ---------------------------------------------------------------------------

class MasterState(NamedTuple):
    master: Any      # float32 copies of the (bf16) params
    inner: Any


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) if x.is_floating_point() else x


def with_master_weights(opt: Optimizer) -> Optimizer:
    """Keep float32 master copies in the optimizer state; the model's
    params stay in their dtype.  Updates are computed on the masters,
    and each step returns the params' delta in the params' dtype
    (cast(new master) − param), so tiny updates are never swallowed by
    bf16 rounding."""

    def init(params):
        master = tree_map(_f32, params)
        return MasterState(master, opt.init(master))

    def update(grads, state, params):
        upd, inner = opt.update(tree_map(_f32, grads), state.inner,
                                state.master)
        new_master = apply_updates(state.master, upd)
        deltas = tree_map(lambda nm, p: nm.to(p.dtype) - p, new_master, params)
        return deltas, MasterState(new_master, inner)

    return Optimizer(init, update)


def make_optimizer(name: str, lr: ScalarOrSchedule, *,
                   master_weights: bool = False, **kw) -> Optimizer:
    opt = {"sgd": sgd, "adam": adam, "adamw": adamw,
           "adafactor": adafactor}[name](lr, **kw)
    return with_master_weights(opt) if master_weights else opt

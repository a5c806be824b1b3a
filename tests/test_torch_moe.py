"""The MoE block (``models/moe.py``) against the JAX package's
``apply_moe`` on the same numpy inputs and params, and against its own
plain sequential version ``moe_ref`` (CPU).

The JAX side's discrete decisions — each token's expert ids, best first,
and which choices capacity kept — are recomputed here with
``jax.lax.top_k`` and the one-hot cumulative count, as its group body
takes them.  Ids and the kept mask must be equal exactly.  In float32,
y, ``load_balance`` and ``router_z`` agree at rtol 1e-5 (atol 1e-5 of
the largest entry).  In bf16 (params and activations) the aux losses
agree to a relative L2 of 2^-8, and y is held to the float32 block on
the same (bf16) values, whose routing is the same since the router's
sums are float32: the port's relative L2 error there may exceed JAX's
by at most 2^-9.  (Held to JAX's bf16 y directly, 2^-8 fails by a
quarter ulp: JAX's CPU backend rounds silu's and gelu's every primitive
step — neg, exp, add, divide, multiply — to bf16, ``F.silu`` once.)
``moe_ref`` agrees with ``apply_moe`` at the same tolerances, bf16 at a
relative L2 of 2^-8.  Cases: whole groups, a padded group, fewer tokens
than a group, a decode-sized pool at capacity 1 whose rows collide;
swiglu, geglu and a plain gelu; shared experts on and off.  Hand-built:
token-major capacity order, and all-zero rows, which route to experts
0..k-1.

The block split over the ``model`` mesh axis as a sharded step splits
it (``apply_moe(split=)``): each rank's float32 partial output on its
experts (EP) or its columns of every expert (expert TP), with its
columns of the shared MLP, summed over the ranks, against JAX's
``apply_moe`` (rtol 1e-5, atol 1e-5 of the largest entry) and the port's
whole block (rtol 1e-6, atol 1e-6 of the largest: at most 1.4e-7 of the
largest measured), the aux losses the whole block's bit for bit on every
rank; and on a ``gloo`` world of one, the split block through
``block_split`` and ``materialize_period`` is the whole block bit for
bit, forward and gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import _to_tensor
from repro_torch.models import moe
from repro_torch.models.transformer import tree_map
from torch_multidevice_ranks import moe_rank_block
from torch_reference import jax_lm  # noqa: F401  (fixture)

RTOL = 1e-5
BF16_REL_L2 = 2.0 ** -8
D, F_FF, SHARED_FF = 32, 24, 48

# name -> (batch, time, group size, experts, top-k)
SHAPES = {"whole groups": (2, 16, 16, 6, 2),
          "padded group": (1, 37, 16, 6, 2),
          "below a group": (2, 5, 16, 6, 2),
          "decode, cap 1": (4, 1, 16, 8, 2)}
BLOCKS = (("swiglu", 2), ("swiglu", 0), ("geglu", 2), ("gelu", 0))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_decisions(jparams, x, *, num_experts, top_k, capacity_factor,
                   group_size):
    """JAX's expert ids (G, S, K) and kept mask, as its group body takes
    them (``repro/models/moe.py``)."""
    b, t, d = x.shape
    n = b * t
    s = min(group_size, n)
    xf = jnp.pad(x.reshape(n, d), ((0, -n % s), (0, 0)))
    xg = xf.reshape(-1, s, d)
    cap = max(1, int(s * top_k * capacity_factor / num_experts))
    router = jnp.asarray(jparams["router"]["kernel"]).astype(x.dtype)
    logits = jnp.einsum("gsd,de->gse", xg, router,
                        preferred_element_type=jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    oh = jax.nn.one_hot(idx, num_experts, dtype=jnp.float32)
    g = xg.shape[0]
    pos = jnp.cumsum(oh.reshape(g, s * top_k, num_experts), axis=1) \
        .reshape(oh.shape) * oh - 1.0
    keep = jnp.any((pos < cap) & (oh > 0), axis=-1)
    return np.asarray(idx), np.asarray(keep)


def _pair(jax_lm, dtype, activation, shared, num_experts, seed=0):
    """JAX params (in ``dtype``) and the port's copy of them."""
    jdt, _ = DTYPES[dtype]
    jparams, _ = jax_lm.transformer.moe_lib.init_moe(
        jax.random.key(seed), D, F_FF, num_experts, shared,
        SHARED_FF if shared else 0, activation)
    jparams = jax.tree.map(lambda a: np.asarray(a.astype(jdt)), jparams)
    return jparams, jax.tree.map(_to_tensor, jparams)


def _inputs(b, t, dtype, seed, collide=False):
    x = np.random.default_rng(seed).standard_normal((b, t, D)).astype(
        np.float32)
    if collide:
        x[1] = x[0]                     # the same choices as row 0
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    return jx, _to_tensor(np.asarray(jx))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel_l2(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype):
    if dtype == "float32":
        want = _f32(want)
        np.testing.assert_allclose(_f32(got), want, rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()))
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2, _rel_l2(got, want)


def _check(jax_lm, jparams, params, jx, x, dtype, **kw):
    """apply_moe vs JAX's apply_moe and vs moe_ref; returns the routing."""
    jy, jaux = jax_lm.transformer.moe_lib.apply_moe(
        jax.tree.map(jnp.asarray, jparams), jx, **kw)
    rkw = {k: v for k, v in kw.items() if k != "activation"}
    y, aux = moe.apply_moe(params, x, **kw)
    r = moe.route(params, x, **rkw)
    ids, keep = _jax_decisions(jparams, jx, **rkw)
    np.testing.assert_array_equal(r.experts.numpy(), ids)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert y.dtype == x.dtype and y.shape == x.shape
    if dtype == "float32":
        _close(y, jy, dtype)
    else:
        params32 = tree_map(lambda t: t.float(), params)
        true, _ = moe.apply_moe(params32, x.float(), **kw)
        assert torch.equal(moe.route(params32, x.float(), **rkw).experts,
                           r.experts)
        assert _rel_l2(y, true) <= _rel_l2(jy, true) + 2.0 ** -9, \
            (_rel_l2(y, true), _rel_l2(jy, true))
    for key in ("load_balance", "router_z"):
        _close(aux[key], jaux[key], dtype)
    ry, raux, rids, rkeep = moe.moe_ref(params, x, **kw)
    assert torch.equal(rids, r.experts) and torch.equal(rkeep, r.keep)
    for got, want in ((y, ry), (aux["load_balance"], raux["load_balance"]),
                      (aux["router_z"], raux["router_z"])):
        _close(got, want, dtype)
    return r


@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: f"{b[0]}-shared{b[1]}")
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_moe_matches_jax_and_ref(jax_lm, dtype, shape, block):
    b, t, group, e, k = SHAPES[shape]
    activation, shared = block
    jparams, params = _pair(jax_lm, dtype, activation, shared, e)
    decode = shape.startswith("decode")
    jx, x = _inputs(b, t, dtype, seed=len(shape), collide=decode)
    r = _check(jax_lm, jparams, params, jx, x, dtype, num_experts=e,
               top_k=k, activation=activation, capacity_factor=1.25,
               group_size=group)
    assert r.n == b * t and r.logits.shape[0] * r.logits.shape[1] >= b * t
    if decode:
        assert r.cap == 1
        assert not bool(r.keep[0, 1].any())      # row 1 collides with row 0
    if shape == "padded group":
        assert r.logits.shape[:2] == (3, 16)


def test_token_major_capacity_order(jax_lm):
    """Two experts, top-2, capacity 1: token 0 takes expert 0 then 1;
    token 1 prefers expert 1, whose slot token 0's second choice already
    took — so token 1 keeps nothing (Switch's first-choices-first order
    would have dropped token 0's second choice instead), and its output
    is the shared experts' alone."""
    jparams, params = _pair(jax_lm, "float32", "swiglu", 2, 2, seed=3)
    router = np.zeros((D, 2), np.float32)
    router[0] = (2.0, 1.0)
    router[1] = (1.0, 2.0)
    jparams["router"]["kernel"] = router
    params["router"]["kernel"] = torch.from_numpy(router.copy())
    x = np.zeros((1, 2, D), np.float32)
    x[0, 0, 0] = x[0, 1, 1] = 1.0
    kw = dict(num_experts=2, top_k=2, activation="swiglu",
              capacity_factor=0.5, group_size=16)
    r = _check(jax_lm, jparams, params, jnp.asarray(x), torch.from_numpy(x),
               "float32", **kw)
    assert r.cap == 1
    assert r.experts.tolist() == [[[0, 1], [1, 0]]]
    assert r.keep.tolist() == [[[True, True], [False, False]]]
    y, _ = moe.apply_moe(params, torch.from_numpy(x), **kw)
    shared = moe._shared(params, torch.from_numpy(x), "swiglu")
    assert torch.equal(y[0, 1], shared[0, 1])
    assert not torch.equal(y[0, 0], shared[0, 0])


@pytest.mark.parametrize("top_k", (1, 2, 3))
def test_zero_rows_route_to_the_lowest_ids(jax_lm, top_k):
    """All-zero rows have uniform probabilities: every expert ties, and
    JAX's top-k (like the port's stable sort) picks 0..k-1.  Zero rows
    mixed with others, and the pad rows, count in the aux means."""
    jparams, params = _pair(jax_lm, "float32", "swiglu", 0, 6, seed=4)
    x = np.random.default_rng(5).standard_normal((1, 21, D)).astype(
        np.float32)
    x[0, ::2] = 0.0
    r = _check(jax_lm, jparams, params, jnp.asarray(x), torch.from_numpy(x),
               "float32", num_experts=6, top_k=top_k, activation="swiglu",
               capacity_factor=4.0, group_size=16)
    flat = r.experts.reshape(-1, top_k)
    zero_rows = list(range(0, 21, 2)) + list(range(21, 32))   # + the pad
    assert flat[zero_rows].tolist() == [list(range(top_k))] * len(zero_rows)


def test_init_moe_tree_matches_jax(jax_lm):
    """init_moe's tree, shapes and dtypes equal JAX's; the expert kernels
    take JAX's fan-in (shape[0] = E)."""
    e = 60
    jparams, _ = jax_lm.transformer.moe_lib.init_moe(
        jax.random.key(0), D, F_FF, e, 4, SHARED_FF, "swiglu")
    params = moe.init_moe(torch.Generator().manual_seed(0), D, F_FF, e, 4,
                          SHARED_FF, "cpu", "swiglu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert params["shared_gate"]["kernel"].shape == (D, 1)
    for key in ("wi", "wg", "wo"):
        got = float(params[key]["kernel"].std())
        want = float(jnp.std(jparams[key]["kernel"]))
        assert abs(got - want) < 0.02 * want, (key, got, want)
    plain = moe.init_moe(None, D, F_FF, 4, 0, 0, "cpu", "gelu")
    assert sorted(plain) == ["router", "wi", "wo"]


# the experts split n ways: (how, n) -- by expert (6 experts over 2 and 3
# ranks) or by columns (24 columns over 2 and 4; the shared MLP's 48 too)
SPLITS = (("experts", 2), ("experts", 3), ("columns", 2), ("columns", 4))
SPLIT_RTOL = 1e-6


class FakeMesh:
    """The mesh a split names: axis sizes and names only (no collective
    runs: the ranks' partials are summed here)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("shape", ["whole groups", "padded group"])
@pytest.mark.parametrize("how,n", SPLITS, ids=lambda v: str(v))
def test_split_partials_sum_to_jax(jax_lm, how, n, shape):
    """Six experts, top-2, swiglu, two shared experts, float32: rank k's
    partial output is ``apply_moe(split=)`` on its shards
    (``moe_rank_block``: experts [k·E/n, (k+1)·E/n) or every expert's
    columns [k·F/n, (k+1)·F/n), the shared MLP's columns, the router and
    ``shared_gate`` whole) with no split dims, so ``into`` and ``out_of``
    hand the partial back as it is.  The n partials summed equal JAX's
    ``apply_moe`` and the port's whole block; every rank's aux losses are
    the whole block's bit for bit (each routes the whole input)."""
    b, t, group, e, k = SHAPES[shape]
    jparams, params = _pair(jax_lm, "float32", "swiglu", 2, e)
    jx, x = _inputs(b, t, "float32", seed=n)
    kw = dict(num_experts=e, top_k=k, activation="swiglu",
              capacity_factor=1.25, group_size=group)
    jy, _ = jax_lm.transformer.moe_lib.apply_moe(
        jax.tree.map(jnp.asarray, jparams), jx, **kw)
    whole, aux = moe.apply_moe(params, x, **kw)
    mesh = FakeMesh({"data": 1, "model": n})
    total = torch.zeros_like(whole)
    for rank in range(n):
        local, split = moe_rank_block(params, how, n, rank, mesh)
        assert (split.experts if how == "experts" else split.columns) \
            is split.routed and split.shared is not None
        y, rank_aux = moe.apply_moe(local, x, split=split, **kw)
        assert y.dtype == torch.float32 and y.shape == x.shape
        for key in aux:
            assert torch.equal(rank_aux[key], aux[key]), key
        total += y
    _close(total, jy, "float32")
    np.testing.assert_allclose(
        total.numpy(), whole.numpy(), rtol=SPLIT_RTOL,
        atol=SPLIT_RTOL * float(whole.abs().max()))


@pytest.mark.parametrize("how", ["experts", "columns"])
def test_world1_split_block_is_the_whole_block(how, tmp_path):
    """The smoke qwen2-moe-a2.7b's block (float32) on a ``gloo`` world of
    one, mesh (1, 1): its params placed by the rules (the experts
    sharded on ``model`` by expert) or with the expert kernels sharded
    there by columns (wi's and wg's last dim, wo's hidden dim), split by
    ``block_split`` and gathered by ``materialize_period`` inside a
    step's activation.  ``apply_block(split=)`` equals the unsplit
    block bit for bit: its output, aux losses, and the gradients of
    x and of every param."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.sharding import (NamedSharding, ShardingRules, activate,
                                      block_split, params_shardings, place)
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True),
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    block = transformer.init_block(gen, cfg, "moe", "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    dy = torch.randn(x.shape, generator=gen)
    pos = torch.arange(16)[None].expand(2, -1)

    def run(params, split=None):
        leaves = [leaf.requires_grad_(True) for _, leaf in
                  tree_flatten(params)]
        xg = x.clone().requires_grad_(True)
        used = transformer.materialize_period([params], [split])[0] \
            if split is not None else params
        y, _, aux = transformer.apply_block(used, cfg, "moe", xg, pos,
                                            split=split)
        loss = (y * dy).sum() + aux["load_balance"] + aux["router_z"]
        grads = torch.autograd.grad(loss, [xg] + leaves)
        return [y, aux["load_balance"], aux["router_z"]] + [
            g.to_local() if isinstance(g, DTensor) else g for g in grads]

    want = run(transformer.tree_map(lambda t: t.clone(), block))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = ShardingRules()
        shard = params_shardings(mesh, rules,
                                 transformer.block_axes(cfg, "moe"), block)
        if how == "columns":
            for key in ("wi", "wg", "wo"):
                shard["moe"][key]["kernel"] = NamedSharding(
                    mesh, (None, "model", "data") if key == "wo"
                    else (None, "data", "model"))
        placed = place(block, shard)
        with activate(mesh, rules, batch_axes=("data",)):
            split = block_split(placed)
            assert split.attn is not None and split.moe is not None
            assert split.moe.routed is (split.moe.experts if how == "experts"
                                        else split.moe.columns)
            assert (split.moe.routed.r0, split.moe.routed.r1) == (
                0, cfg.num_experts if how == "experts" else cfg.moe_d_ff)
            assert (split.moe.shared.r0, split.moe.shared.r1) == (
                0, cfg.shared_d_ff)
            got = run(placed, split)
    finally:
        dist.destroy_process_group()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i


@pytest.mark.parametrize("top_k,dtype", [(2, torch.float32), (4, torch.float32),
                                         (4, torch.bfloat16)])
def test_dispatch_backward_is_the_gather_transpose(top_k, dtype):
    """The dispatch's backward (``moe._Dispatch``: each token's kept rows
    gathered and summed over its K choices, no scatter-add) against
    autograd of the plain gather on the same routing (8 experts, groups
    of 16 over 3 groups, capacity 0.5 so choices drop): exactly equal at
    top-2 in float32 (a sum of two terms does not depend on its order),
    else at rtol 1e-6 (float32) or within a bf16 ulp (the gather's
    scatter-add rounds each add to bf16, the sum rounds once); the
    forward equal."""
    gen = torch.Generator().manual_seed(top_k)
    e, d, group = 8, 16, 16
    params = moe.init_moe(gen, d, 8, e, 0, 0, "cpu", "swiglu")
    x = torch.randn((3, group, d), generator=gen).to(dtype)
    r = moe.route(params, x, num_experts=e, top_k=top_k,
                  capacity_factor=0.5, group_size=group)
    assert not bool(r.keep.all())
    g, s, cap = 3, group, r.cap
    row = r.experts * cap + r.slot.clamp(max=cap - 1)
    owner = torch.full((g, e * cap + 1), s, dtype=torch.long)
    owner.scatter_(1, torch.where(r.keep, row, e * cap).reshape(g, -1),
                   torch.arange(s)[None, :, None].expand_as(row)
                   .reshape(g, -1))
    xg = x.reshape(g, s, d)
    up = torch.randn((g, e * cap, d), generator=gen).to(dtype)
    xa = xg.clone().requires_grad_(True)
    got = moe._Dispatch.apply(xa, owner[:, :-1], row, r.keep)
    dx, = torch.autograd.grad(got, xa, up)
    xb = xg.clone().requires_grad_(True)
    xz = torch.cat([xb, xb.new_zeros((g, 1, d))], 1)
    want = torch.gather(xz, 1, owner[:, :-1, None].expand(-1, -1, d))
    dw, = torch.autograd.grad(want, xb, up)
    assert torch.equal(got, want)
    if top_k == 2 and dtype == torch.float32:
        assert torch.equal(dx, dw)
    elif dtype == torch.float32:
        torch.testing.assert_close(dx, dw, rtol=1e-6, atol=1e-6)
    else:
        ulp = dw.float().abs().clamp(min=2.0 ** -100) * 2.0 ** -7
        assert bool(((dx.float() - dw.float()).abs() <= ulp).all())

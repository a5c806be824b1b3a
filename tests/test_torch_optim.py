"""The port's ``optim`` package against the JAX package's ``repro.optim``:
the same numpy params and gradients through 3 steps of each optimizer,
the schedules at a run of steps, clipping and microbatch accumulation.
Both compute in float32 with the same formulas, so results agree at rtol
1e-6 (atol 1e-7 for entries near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jo
from repro_torch import optim as to

RTOL, ATOL = 1e-6, 1e-7


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "nested": {"k": rng.normal(size=(3, 2, 2)).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want):
    flat_got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(0.1), {}),
    "sgd_momentum": (lambda m: m.sgd(0.1, momentum=0.9), {}),
    "sgd_nesterov": (lambda m: m.sgd(0.05, momentum=0.9, nesterov=True), {}),
    "adam": (lambda m: m.adam(1e-2), {}),
    "adamw_decay": (lambda m: m.adamw(1e-2, weight_decay=0.1), {}),
    "adamw_schedule": (lambda m: m.adamw(m.warmup_cosine(0.05, 2, 10),
                                         weight_decay=0.01), {}),
    "adafactor": (lambda m: m.adafactor(1e-2), {}),
    "adafactor_schedule": (lambda m: m.adafactor(
        m.warmup_cosine(0.05, 2, 10), clip_threshold=0.5, decay_rate=0.6), {}),
    "make_adafactor": (lambda m: m.make_optimizer("adafactor", 1e-2), {}),
    "make_adamw_master": (lambda m: m.make_optimizer(
        "adamw", 1e-2, master_weights=True, weight_decay=0.1), {}),
    "make_sgd_master": (lambda m: m.make_optimizer(
        "sgd", 0.1, master_weights=True, momentum=0.9), {}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_repro_optim_over_three_steps(name):
    make, _ = OPTIMIZERS[name]
    jopt, topt = make(jo), make(to)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _to_torch(_tree(0))
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = _tree(100 + step)
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        tupd, tstate = topt.update(_to_torch(grads), tstate, tp)
        _close(tupd, jupd)
        jp = jo.apply_updates(jp, jupd)
        tp = to.apply_updates(tp, tupd)
        _close(tp, jp)


def test_adamw_default_mask_decays_only_matrices():
    """Default mask: ndim >= 2 decays; the bias (ndim 1) does not."""
    opt = to.adamw(0.1, weight_decay=0.5)
    params = _to_torch(_tree(1))
    zero = jax.tree.map(torch.zeros_like, params)
    upd, _ = opt.update(zero, opt.init(params), params)
    assert torch.equal(upd["b"], torch.zeros(4))
    np.testing.assert_allclose(upd["w"].numpy(), -0.05 * params["w"].numpy(),
                               rtol=1e-6)
    custom = to.adamw(0.1, weight_decay=0.5,
                      mask=lambda p: jax.tree.map(lambda _: False, p))
    upd, _ = custom.update(zero, custom.init(params), params)
    assert not upd["w"].any()


SCHEDULES = [("constant", {"value": 0.3}),
             ("linear_warmup", {"peak": 1.0, "warmup_steps": 5}),
             ("warmup_cosine", {"peak": 1.0, "warmup_steps": 3,
                                "total_steps": 12, "end_value": 0.1}),
             ("warmup_rsqrt", {"peak": 2.0, "warmup_steps": 4})]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match(name, kw):
    jfn = getattr(jo, name)(**kw)
    tfn = getattr(to, name)(**kw)
    made = to.make_schedule(name, **kw)
    for step in range(15):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(tfn(step)), want, rtol=RTOL)
        np.testing.assert_allclose(float(made(step)), want, rtol=RTOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches(max_norm):
    grads = _tree(7)
    jclipped, jnorm = jo.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), max_norm)
    tclipped, tnorm = to.clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=RTOL)
    np.testing.assert_allclose(float(to.global_norm(_to_torch(grads))),
                               float(jo.global_norm(grads)), rtol=RTOL)
    _close(tclipped, jclipped)


def test_accumulate_grads_matches():
    rng = np.random.default_rng(9)
    batch = {"x": rng.normal(size=(8, 6)).astype(np.float32),
             "y": rng.normal(size=(8, 4)).astype(np.float32)}
    params = {"w": _tree(2)["w"]}

    def jloss(p, b):
        err = b["x"] @ p["w"] - b["y"]
        return jnp.mean(err ** 2), {"abs": jnp.mean(jnp.abs(err))}

    def tloss(p, b):
        err = b["x"] @ p["w"] - b["y"]
        return torch.mean(err ** 2), {"abs": torch.mean(torch.abs(err))}

    for micro in (1, 4):
        (jl, jm), jg = jo.accumulate_grads(
            jloss, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, batch), micro)
        (tl, tm), tg = to.accumulate_grads(tloss, _to_torch(params),
                                           _to_torch(batch), micro)
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
        np.testing.assert_allclose(float(tm["abs"]), float(jm["abs"]), rtol=RTOL)
        _close(tg, jg)


@pytest.mark.parametrize("inner", ["adamw", "adafactor"])
def test_master_weights_on_bfloat16_params_match(inner):
    """bf16 params, float32 masters: the masters, the bf16 deltas
    (cast(new master) − param) and the params equal JAX's after 3 steps
    (rtol 1e-6 on the masters; the bf16 values exactly, as they come
    from the same float32 masters)."""
    kw = {"weight_decay": 0.1} if inner == "adamw" else {}
    jopt = jo.make_optimizer(inner, 1e-2, master_weights=True, **kw)
    topt = to.make_optimizer(inner, 1e-2, master_weights=True, **kw)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), _tree(3))
    tp = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).bfloat16(), jp)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    assert all(t.dtype == torch.float32
               for t in jax.tree.leaves(tstate.master))
    for step in range(3):
        grads = _tree(200 + step)
        g16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                           grads)
        jupd, jstate = jopt.update(g16, jstate, jp)
        tupd, tstate = topt.update(jax.tree.map(lambda a: torch.from_numpy(
            np.array(a.astype(jnp.float32))).bfloat16(), g16), tstate, tp)
        jp = jo.apply_updates(jp, jupd)
        tp = to.apply_updates(tp, tupd)
        _close(tstate.master, jstate.master)
        for got, want in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


def test_adafactor_state_is_factored_float32():
    """Row and column factors for >= 2-D leaves, the full v below."""
    opt = to.adafactor(0.1)
    state = opt.init(_to_torch(_tree(0)))
    assert state.vr["w"].shape == (6,) and state.vc["w"].shape == (4,)
    assert state.vr["nested"]["k"].shape == (3, 2)
    assert state.vc["nested"]["k"].shape == (3, 2)
    assert state.vr["b"].shape == (4,) and state.vc["b"].shape == (0,)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(state.vr))

"""The MoE decoders' configs (qwen2-moe-a2.7b, mixtral-8x22b) against the
JAX package's, and their smoke models against the JAX package's on the
same params (float32, CPU).

Configs equal field for field (smoke, and full at each MACH setting),
with the same analytic parameter counts and the same shape
applicability.  The smoke models (qwen2-moe: 6 experts top-2, 2 shared,
the MACH head; mixtral: 4 experts top-2, sliding window 8, the OAA
head), params carried across by ``convert_lm_params``, give the same
total loss (the CE plus the load-balance and router-z terms), metrics
and gradients as ``jax.value_and_grad(model.loss)`` at rtol 1e-5 with
remat on and off, on a batch whose tokens pad their last routing group;
the same caches (ring strips at mixtral's window) and hidden states
through a prefill and three decode steps; the same three AdamW trainer
steps; and the same greedy tokens, gauges and pool leaves, tick by tick,
from the continuous and paged engines as the JAX engines, on a ragged
mix whose long prompt pads a group and whose pooled decode steps drop a
choice at capacity 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import trainer as jtrainer
from repro.train.train_state import new_train_state as jax_new_train_state
from repro_torch import configs
from repro_torch.convert import convert_lm_params
from repro_torch.models import moe
from repro_torch.models.model import LanguageModel
from repro_torch.optim import value_and_grad
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.train import TrainConfig, make_train_step, new_train_state
from test_torch_dense_archs import _assert_config_equal
from test_torch_paged_serving import _assert_traces_equal, _trace
from torch_lm_cases import leaves
from torch_reference import jax_lm  # noqa: F401  (fixture)

ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")
RTOL = 1e-5
T = 20                   # 2 x 20 tokens: three groups of 16, the last padded
ENGINE = dict(max_len=32, num_slots=2, max_new_tokens=6)
MIX = [(list(range(3, 22)), 5), ([4, 5, 6], 3), ([7, 8, 9, 10, 11, 12, 13], 6),
       ([14, 15], 4)]    # 19 tokens: a padded group


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(jax_lm, arch):
    assert arch in configs.ARCH_IDS
    _assert_config_equal(configs.get_config(arch, smoke=True),
                         jax_lm.configs.get_config(arch, smoke=True))
    for mach in ("auto", "on", "off"):
        _assert_config_equal(configs.get_config(arch, mach=mach),
                             jax_lm.configs.get_config(arch, mach=mach))


@pytest.mark.parametrize("mach", ("auto", "on", "off"))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_estimate_equals_jax(jax_lm, arch, mach):
    got = configs.get_config(arch, mach=mach).param_count_estimate()
    assert got == jax_lm.configs.get_config(
        arch, mach=mach).param_count_estimate()


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicability_equals_jax(jax_lm, arch):
    cfg = configs.get_config(arch)
    jcfg = jax_lm.configs.get_config(arch)
    assert configs.supports_long_context(cfg) == \
        jax_lm.configs.supports_long_context(jcfg)
    for shape in configs.SHAPES:
        assert configs.shape_applicable(cfg, shape) == \
            jax_lm.configs.shape_applicable(jcfg, shape)


def _pair(jax_lm, arch, **overrides):
    jmodel = jax_lm.models.LanguageModel(dataclasses.replace(
        jax_lm.configs.get_config(arch, smoke=True), **overrides))
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
    model = LanguageModel(dataclasses.replace(
        configs.get_config(arch, smoke=True), **overrides))
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module", params=ARCHS)
def smoke_pair(request, jax_lm):
    return (jax_lm,) + _pair(jax_lm, request.param)


def _close(got, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _batch(vocab, seed):
    tokens = np.random.default_rng(seed).integers(0, vocab, (2, T + 1))
    tokens = tokens.astype(np.int32)
    return {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}


@pytest.mark.parametrize("remat", ("none", "full"))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_metrics_and_grads_match(jax_lm, arch, remat):
    jmodel, jparams, model, params = _pair(jax_lm, arch, remat=remat)
    jbatch, tbatch = _batch(model.cfg.vocab_size, seed=1)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, jbatch)
    (loss, met), grads = value_and_grad(model.loss, params, tbatch,
                                        has_aux=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert sorted(met) == sorted(jmet) == ["load_balance", "loss",
                                           "router_z", "tokens"]
    for key in met:
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=RTOL)
    cfg = model.cfg
    assert float(loss) == pytest.approx(
        float(met["loss"]) + cfg.lb_loss_coef * float(met["load_balance"])
        + cfg.z_loss_coef * float(met["router_z"]), rel=1e-6)
    jgrads = convert_lm_params(model, jax.tree.map(np.asarray, jgrads),
                               device="cpu")
    router = grads["stacks"][0][0]["moe"]["router"]["kernel"]
    assert float(router.abs().max()) > 0
    for got, want in zip(leaves(grads), leaves(jgrads)):
        _close(got.numpy(), want.numpy())


def test_caches_match_jax(smoke_pair):
    """``init_caches`` / ``init_paged_caches`` treat ``moe`` layers as
    attention, as the JAX package does: linear strips, or a ring of
    ``window`` rows at mixtral's window; paged pools where not a ring."""
    jax_lm, jmodel, _, model, _ = smoke_pair
    for got, want in ((model.init_caches(2, 32, device="cpu"),
                       jmodel.init_caches(2, 32)),
                      (model.init_paged_caches(2, 32, 4, 16, device="cpu"),
                       jmodel.init_paged_caches(2, 32, 4, 16))):
        got_leaves = [c for stack in got for c in stack]
        want_leaves = [c for stack in want for c in stack]
        assert [type(c).__name__ for c in got_leaves] == \
            [type(c).__name__ for c in want_leaves]
        for g, w in zip(got_leaves, want_leaves):
            for name in w._fields:
                gs, ws = tuple(getattr(g, name).shape), getattr(w, name).shape
                if name in ("k", "v", "positions") and \
                        type(g).__name__ == "PagedKVCache":
                    gs = gs[:1] + (gs[1] - 1,) + gs[2:]     # the spare page
                assert gs == tuple(ws), (name, gs, ws)
    window = model.cfg.block_window("moe")
    cap = model.init_caches(2, 32, device="cpu")[0][0].k.shape[2]
    assert cap == (window if window is not None else 32)


def test_prefill_and_decode_match(smoke_pair):
    _, jmodel, jparams, model, params = smoke_pair
    rng = np.random.default_rng(2)
    vocab = model.cfg.vocab_size
    prompt = rng.integers(0, vocab, (2, 9)).astype(np.int32)
    feed = rng.integers(0, vocab, (3, 2)).astype(np.int32)
    jcaches, _, jh = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                    32)
    caches, h = model.prefill(params, torch.from_numpy(prompt), 32)
    _close(h.numpy(), jh)
    for step, tok in enumerate(feed):
        pos = np.full((2,), prompt.shape[1] + step, np.int32)
        jcaches, jh = jmodel.decode_step(jparams, jcaches, None,
                                         jnp.asarray(tok), jnp.asarray(pos))
        caches, h = model.decode_step(params, caches, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        _close(h.numpy(), jh)
    for got, want in zip([c for st in caches for c in st],
                         [c for st in jcaches for c in st]):
        for name in want._fields:
            _close(getattr(got, name).numpy(), getattr(want, name))


def test_three_trainer_steps_match(smoke_pair):
    _, jmodel, jparams, model, params = smoke_pair
    tc = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10,
              optimizer="adamw")
    jstep, jopt = jtrainer.make_train_step(jmodel.loss,
                                           jtrainer.TrainConfig(**tc))
    step, opt = make_train_step(model.loss, TrainConfig(**tc))
    jstate = jax_new_train_state(jparams, jopt)
    state = new_train_state(params, opt)
    jstep = jax.jit(jstep)
    lr_sum = 0.0
    for s in range(3):
        jbatch, tbatch = _batch(model.cfg.vocab_size, seed=10 + s)
        jstate, jmet = jstep(jstate, jbatch)
        state, met = step(state, tbatch)
        for key in ("loss", "load_balance", "router_z", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=RTOL)
        lr_sum += float(met["lr"])
    want = convert_lm_params(model, jax.tree.map(np.asarray, jstate.params),
                             device="cpu")
    off = total = 0
    for got, w in zip(leaves(state.params), leaves(want)):
        err = (got - w).abs()
        assert float(err.max()) <= 2 * lr_sum
        off += int((err > RTOL * float(w.abs().max())).sum())
        total += err.numel()
    assert off <= 1e-4 * total, off


@pytest.mark.parametrize("page_size", (0, 4), ids=("contiguous", "paged"))
def test_engines_match_jax_tick_by_tick(smoke_pair, monkeypatch, page_size):
    jax_lm, jmodel, jparams, model, params = smoke_pair
    decode_drops = []
    route = moe.route

    def recording(p, x, **kw):
        r = route(p, x, **kw)
        if x.shape[1] == 1:                       # a pooled decode step
            decode_drops.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(moe, "route", recording)
    kw = dict(ENGINE, page_size=page_size)
    js = jax_lm.serving
    got = _trace(ServingEngine(model, params, ServeConfig(**kw)),
                 [Request(prompt=p, max_new_tokens=mn) for p, mn in MIX])
    want = _trace(js.ServingEngine(jmodel, jparams, js.ServeConfig(**kw)),
                  [js.Request(prompt=p, max_new_tokens=mn) for p, mn in MIX])
    _assert_traces_equal(got, want)
    done = sorted(r for tick in got for r in tick["results"])
    assert [len(r[1]) for r in done] == [mn for _, mn in MIX]
    assert sum(decode_drops) > 0, decode_drops

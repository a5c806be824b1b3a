"""The dense decoders' configs (tinyllama-1.1b, phi3-mini-3.8b, granite-20b,
mistral-large-123b) against the JAX package's, and their smoke models
against the JAX package's on the same params (float32, CPU).

Configs equal field for field (smoke, and full at each MACH setting),
with the same analytic parameter counts and the same shape
applicability.  The smoke models, params carried across by
``convert_lm_params`` (granite: layernorm biases, a non-gated MLP, MQA
with one KV head), give the same loss and logits at rtol 1e-5, the same
hidden states through a prefill and three decode steps, and the same
greedy tokens from the paged engine as the JAX paged engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import convert_lm_params
from repro_torch.models.model import LanguageModel
from repro_torch.serving import Request, ServeConfig, ServingEngine
from torch_reference import jax_lm  # noqa: F401  (fixture)

ARCHS = ("tinyllama-1.1b", "phi3-mini-3.8b", "granite-20b",
         "mistral-large-123b")
RTOL = 1e-5
PROMPTS = [([1, 2, 3], 5), ([4, 5], 2), ([6, 7, 8, 9, 10], 5), ([11], 3),
           ([12, 13, 14], 4)]


def _same_value(name, got, want):
    if name in ("dtype", "param_dtype"):
        assert (got is None) == (want is None), name
        if got is not None:
            assert str(got) == f"torch.{jnp.dtype(want).name}", name
    elif name == "mach":
        assert (got is None) == (want is None), name
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    else:
        assert got == want, (name, got, want)


def _assert_config_equal(cfg, jcfg):
    names = [f.name for f in dataclasses.fields(jcfg)]
    assert [f.name for f in dataclasses.fields(cfg)] == names
    for name in names:
        _same_value(name, getattr(cfg, name), getattr(jcfg, name))


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


@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-2b",))
def test_shape_applicability_equals_jax(jax_lm, arch):
    assert configs.SHAPES == jax_lm.configs.SHAPES
    cfg = configs.get_config(arch)
    jcfg = jax_lm.configs.get_config(arch)
    assert configs.supports_long_context(cfg) == \
        jax_lm.configs.supports_long_context(jcfg)
    for shape in configs.SHAPES:
        assert configs.shape_applicable(cfg, shape) == \
            jax_lm.configs.shape_applicable(jcfg, shape)


def test_unported_archs_still_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("xlstm-1b")


@pytest.fixture(scope="module", params=ARCHS)
def smoke_pair(request, jax_lm):
    jmodel = jax_lm.models.LanguageModel(
        jax_lm.configs.get_config(request.param, smoke=True))
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
    model = LanguageModel(configs.get_config(request.param, smoke=True))
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jax_lm, jmodel, jparams, model, params


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def test_smoke_loss_and_logits_match(smoke_pair):
    _, jmodel, jparams, model, params = smoke_pair
    tokens = np.random.default_rng(1).integers(0, 256, (2, 17)).astype(
        np.int32)
    jloss, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens)})
    loss, _ = model.loss(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    jh, _, _ = jmodel.hidden_states(jparams, jnp.asarray(tokens))
    h, _, _ = model.hidden_states(params, torch.from_numpy(tokens))
    _close(model.oaa_logits(params, h), jmodel.oaa_logits(jparams, jh))


def test_smoke_prefill_and_decode_match(smoke_pair):
    _, jmodel, jparams, model, params = smoke_pair
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 256, (2, 9)).astype(np.int32)
    feed = rng.integers(0, 256, (3, 2)).astype(np.int32)
    jcaches, _, jh = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                    32)
    caches, h = model.prefill(params, torch.from_numpy(prompt), 32)
    _close(model.oaa_logits(params, h), jmodel.oaa_logits(jparams, jh))
    for step, tok in enumerate(feed):
        pos = np.full((2,), prompt.shape[1] + step, np.int32)
        jcaches, jh = jmodel.decode_step(jparams, jcaches, None,
                                         jnp.asarray(tok), jnp.asarray(pos))
        caches, h = model.decode_step(params, caches, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        _close(model.oaa_logits(params, h), jmodel.oaa_logits(jparams, jh))


def test_smoke_paged_engine_matches_jax(smoke_pair):
    jax_lm, jmodel, jparams, model, params = smoke_pair
    kw = dict(max_len=32, num_slots=2, max_new_tokens=5, page_size=4)
    eng = ServingEngine(model, params, ServeConfig(**kw))
    js = jax_lm.serving
    jeng = js.ServingEngine(jmodel, jparams, js.ServeConfig(**kw))
    for p, mn in PROMPTS:
        eng.submit(Request(prompt=p, max_new_tokens=mn))
        jeng.submit(js.Request(prompt=p, max_new_tokens=mn))
    outs, jouts = eng.run(), jeng.run()
    assert [r.tokens for r in outs] == [tuple(int(t) for t in r.tokens)
                                        for r in jouts]
    assert eng.metrics.pages_peak == jeng.metrics.pages_peak > 0

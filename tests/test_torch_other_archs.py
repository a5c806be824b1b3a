"""xlstm-350m, seamless-m4t-large-v2 and paligemma-3b: the configs against
the JAX package's, and the smoke models against the JAX package's on the
same params (float32 unless named, CPU).

Configs equal field for field (smoke, and full at each MACH setting),
with the same analytic parameter counts, inside the JAX package's own
size bounds (``tests/test_arch_smoke.py``), and the same shape
applicability (xLSTM runs long_500k).  The full configs construct on the
meta device.  The smoke models, params carried across by
``convert_lm_params`` (the xLSTM subtrees, the cross-attention and the
adapters), with the same numpy tokens and frontend features: hidden
states, loss, metrics and every gradient against
``jax.value_and_grad(model.loss)`` at rtol 1e-5 plus atol 1e-5 of the
largest entry (a gradient that is zero by symmetry, the sLSTM's
input-gate bias, below 1e-6 of the largest gradient entry on both
sides); a prefill (after the vision prefix, over the encoder's
K/V) and three decode steps; one AdamW trainer step against JAX's
``make_train_step``; the engines' greedy tokens, gauges and page-pool
leaves tick by tick against the JAX engines (contiguous, and paged for
the enc-dec and vision models); the engine's refusals of missing,
misshapen, conflicting and unwanted features, message for message.  In
bf16 (params and activations), each model's hidden states are held to
the same model in float32 on the bf16 params with a relative L2 error at
most JAX's own bf16 error there plus 2^-9.
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
from repro_torch.models.model import LanguageModel
from repro_torch.optim import value_and_grad
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.train import TrainConfig, make_train_step, new_train_state
from test_torch_dense_archs import _assert_config_equal
from test_torch_paged_serving import _assert_traces_equal, _trace
from torch_lm_cases import leaves
from torch_reference import jax_lm  # noqa: F401  (fixture)

ARCHS = ("xlstm-350m", "seamless-m4t-large-v2", "paligemma-3b")
# the JAX package's bounds (tests/test_arch_smoke.py); seamless has none
SIZE_BOUNDS = {"xlstm-350m": (0.25e9, 0.55e9), "paligemma-3b": (2e9, 3.5e9)}
RTOL = 1e-5
T = 12
ENC_LEN = 8
ENGINE = dict(max_len=40, num_slots=2, max_new_tokens=6)
MIX = [(list(range(3, 14)), 5), ([4, 5, 6], 3), ([7, 8, 9, 10, 11, 12, 13], 6),
       ([14, 15], 4), ([16], 2)]


def _close(got, want) -> None:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


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
    if arch in SIZE_BOUNDS and mach == "auto":
        lo, hi = SIZE_BOUNDS[arch]
        assert lo < got < hi, (arch, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_constructs_on_meta(arch):
    """The full model's params on the meta device: every block kind of its
    layout, bf16 leaves (float32 gate biases cast with the rest, as the
    JAX package's ``param_dtype`` does), and a size within 1% of the
    analytic estimate (which leaves out the norms, biases and adapters).
    The estimate sums ``layout()``, all ``attn`` for the enc-dec model,
    so it leaves out each decoder layer's cross-attention (q, k, v, o and
    ``norm_x``): that gap is added back."""
    cfg = configs.get_config(arch)
    model = LanguageModel(cfg)
    params = model.init(device="meta")
    ps = leaves(params)
    assert all(p.device.type == "meta" and p.dtype == torch.bfloat16
               for p in ps)
    n = sum(p.numel() for p in ps)
    est = cfg.param_count_estimate()
    if cfg.num_encoder_layers:
        d, hd = cfg.d_model, cfg.resolved_head_dim
        est += cfg.num_layers * (d * hd * (2 * cfg.num_heads
                                           + 2 * cfg.num_kv_heads) + d)
    assert abs(n - est) < 0.01 * est, (arch, n, est)
    if cfg.num_encoder_layers:
        assert "enc_stacks" in params and "enc_adapter" in params
        assert "xattn" in params["stacks"][0][0]
    if cfg.frontend == "vision":
        assert params["vis_adapter"]["proj"]["kernel"].shape == \
            (1152, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicability_equals_jax(jax_lm, arch):
    cfg = configs.get_config(arch)
    jcfg = jax_lm.configs.get_config(arch)
    assert configs.supports_long_context(cfg) == \
        jax_lm.configs.supports_long_context(jcfg) == (arch == "xlstm-350m")
    for shape in configs.SHAPES:
        assert configs.shape_applicable(cfg, shape) == \
            jax_lm.configs.shape_applicable(jcfg, shape)


def _pair(jax_lm, arch, **overrides):
    jmodel = jax_lm.models.LanguageModel(dataclasses.replace(
        jax_lm.configs.get_config(arch, smoke=True), **overrides))
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
    tover = {k: ({jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[v]
                 if k in ("dtype", "param_dtype") and v is not None else v)
             for k, v in overrides.items()}
    model = LanguageModel(dataclasses.replace(
        configs.get_config(arch, smoke=True), **tover))
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module", params=ARCHS)
def smoke_pair(request, jax_lm):
    return (jax_lm,) + _pair(jax_lm, request.param)


def _feats(cfg, b, seed):
    """The frontend features a batch of ``b`` rows of ``cfg`` needs."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.num_encoder_layers:
        out["enc_feats"] = rng.standard_normal(
            (b, ENC_LEN, 1024)).astype(np.float32)
    if cfg.frontend == "vision":
        out["prefix_feats"] = rng.standard_normal(
            (b, cfg.num_prefix_tokens, 1152)).astype(np.float32)
    return out


def _batch(cfg, seed, t=T):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, t + 1)).astype(np.int32)
    arrays = {"tokens": tokens, **_feats(cfg, 2, seed + 100)}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _enc_kvs(model, params, batch):
    if not model.cfg.num_encoder_layers:
        return None
    return model.enc_kvs(params, model.encode(params, batch["enc_feats"]))


def test_hidden_states_loss_and_grads_match(smoke_pair):
    _, jmodel, jparams, model, params = smoke_pair
    jbatch, tbatch = _batch(model.cfg, seed=1)
    jkvs = (jmodel.enc_kvs(jparams, jmodel.encode(jparams,
                                                  jbatch["enc_feats"]))
            if model.cfg.num_encoder_layers else None)
    jh, _, _ = jmodel.hidden_states(jparams, jbatch["tokens"],
                                    prefix_emb=jbatch.get("prefix_feats"),
                                    enc_kvs=jkvs)
    h, _, _ = model.hidden_states(params, tbatch["tokens"],
                                  prefix_emb=tbatch.get("prefix_feats"),
                                  enc_kvs=_enc_kvs(model, params, tbatch))
    assert h.shape == jh.shape
    _close(h, jh)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, jbatch)
    (loss, met), grads = value_and_grad(model.loss, params, tbatch,
                                        has_aux=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert sorted(met) == sorted(jmet)
    for key in met:
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=RTOL)
    jgrads = convert_lm_params(model, jax.tree.map(np.asarray, jgrads),
                               device="cpu")
    # a leaf whose true gradient is zero holds float noise on both sides:
    # the sLSTM's input-gate bias (c / n is invariant to a shift of every
    # log i by one constant)
    noise = 1e-6 * max(float(w.abs().max()) for w in leaves(jgrads))
    for got, want in zip(leaves(grads), leaves(jgrads)):
        if float(want.abs().max()) < noise:
            assert float(got.abs().max()) < noise
            continue
        _close(got, want.numpy())


def test_prefill_and_decode_match(smoke_pair):
    _, jmodel, jparams, model, params = smoke_pair
    rng = np.random.default_rng(2)
    vocab = model.cfg.vocab_size
    prompt = rng.integers(0, vocab, (2, 9)).astype(np.int32)
    feed = rng.integers(0, vocab, (3, 2)).astype(np.int32)
    feats = _feats(model.cfg, 2, seed=3)
    prefix = model.cfg.num_prefix_tokens if "prefix_feats" in feats else 0
    jcaches, jkvs, jh = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(prompt),
                  **{k: jnp.asarray(v) for k, v in feats.items()}}, 32)
    tf = {k: torch.from_numpy(v) for k, v in feats.items()}
    kvs = _enc_kvs(model, params, tf)
    caches, h = model.prefill(params, torch.from_numpy(prompt), 32,
                              enc_kvs=kvs, prefix_feats=tf.get("prefix_feats"))
    _close(h, jh)
    for step, tok in enumerate(feed):
        pos = np.full((2,), prefix + prompt.shape[1] + step, np.int32)
        jcaches, jh = jmodel.decode_step(jparams, jcaches, jkvs,
                                         jnp.asarray(tok), jnp.asarray(pos))
        caches, h = model.decode_step(params, caches, torch.from_numpy(tok),
                                      torch.from_numpy(pos), enc_kvs=kvs)
        _close(h, jh)
    for got, want in zip([c for st in caches for c in st],
                         [c for st in jcaches for c in st]):
        assert type(got).__name__ == type(want).__name__
        for name in want._fields:
            _close(getattr(got, name), getattr(want, name))


def test_one_trainer_step_matches(smoke_pair):
    _, jmodel, jparams, model, params = smoke_pair
    tc = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10,
              optimizer="adamw")
    jstep, jopt = jtrainer.make_train_step(jmodel.loss,
                                           jtrainer.TrainConfig(**tc))
    step, opt = make_train_step(model.loss, TrainConfig(**tc))
    jbatch, tbatch = _batch(model.cfg, seed=10)
    jstate, jmet = jax.jit(jstep)(jax_new_train_state(jparams, jopt), jbatch)
    state, met = step(new_train_state(params, opt), tbatch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=RTOL)
    want = convert_lm_params(model, jax.tree.map(np.asarray, jstate.params),
                             device="cpu")
    lr = float(met["lr"])
    off = total = 0
    for path, got, w in zip(_paths(state.params), leaves(state.params),
                            leaves(want)):
        err = (got - w).abs()
        assert float(err.max()) <= 2 * lr
        if path.endswith("slstm/gate_bias/i"):
            continue        # a zero gradient: AdamW steps by its noise's sign
        off += int((err > RTOL * float(w.abs().max())).sum())
        total += err.numel()
    assert off <= 1e-4 * total, off


def _paths(tree, path=""):
    """Leaf paths in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in _paths(v, path)]
    return [path]


def _requests(cls, cfg, feats_cls=None):
    feats = _feats(cfg, 1, seed=9)
    row = {k: v[0] for k, v in feats.items()}
    return [cls(prompt=p, max_new_tokens=mn, **row) for p, mn in MIX]


@pytest.mark.parametrize("arch,page_size", [
    ("xlstm-350m", 0), ("seamless-m4t-large-v2", 0),
    ("seamless-m4t-large-v2", 4), ("paligemma-3b", 0), ("paligemma-3b", 4)])
def test_engines_match_jax_tick_by_tick(jax_lm, arch, page_size):
    jmodel, jparams, model, params = _pair(jax_lm, arch)
    kw = dict(ENGINE, page_size=page_size)
    js = jax_lm.serving
    got = _trace(ServingEngine(model, params, ServeConfig(**kw)),
                 _requests(Request, model.cfg))
    want = _trace(js.ServingEngine(jmodel, jparams, js.ServeConfig(**kw)),
                  _requests(js.Request, model.cfg))
    _assert_traces_equal(got, want)
    done = sorted(r for tick in got for r in tick["results"])
    assert [len(r[1]) for r in done] == [mn for _, mn in MIX]


def _refusal(engine, request) -> str:
    with pytest.raises(ValueError) as exc:
        engine.submit(request)
    return str(exc.value)


def test_feature_refusals_match_jax(jax_lm):
    """Missing, misshapen, conflicting and unwanted frontend features are
    refused with the JAX engine's messages; a refused request pins no
    encoder shape."""
    js = jax_lm.serving
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((ENC_LEN, 1024)).astype(np.float32)
    other = rng.standard_normal((ENC_LEN + 1, 1024)).astype(np.float32)
    narrow = rng.standard_normal((ENC_LEN, 512)).astype(np.float32)
    vis = rng.standard_normal((4, 1152)).astype(np.float32)
    cases = {
        "seamless-m4t-large-v2": [
            ({}, None), ({"enc_feats": narrow}, None),
            ({"enc_feats": enc[None]}, None),
            ({"enc_feats": enc, "prefix_feats": vis}, None),
            ({"enc_feats": other}, "ok"), ({"enc_feats": enc}, None)],
        "paligemma-3b": [({}, None), ({"prefix_feats": vis[:3]}, None),
                         ({"prefix_feats": vis, "enc_feats": enc}, None)],
        "xlstm-350m": [({"enc_feats": enc}, None),
                       ({"prefix_feats": vis}, None)]}
    for arch, reqs in cases.items():
        jmodel, jparams, model, params = _pair(jax_lm, arch)
        eng = ServingEngine(model, params, ServeConfig(**ENGINE))
        jeng = js.ServingEngine(jmodel, jparams, js.ServeConfig(**ENGINE))
        for feats, accepted in reqs:
            req = dict(prompt=[1, 2, 3], **feats)
            if accepted:
                assert eng.submit(Request(**req)) == \
                    jeng.submit(js.Request(**req))
                continue
            msg = _refusal(eng, Request(**req))
            assert msg == _refusal(jeng, js.Request(**req)), arch
            assert eng._enc_shape == jeng._enc_shape
    assert eng._enc_shape is None


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_hidden_states_within_jax_error(jax_lm, arch):
    """bf16 params and activations on both sides; each held to the port's
    float32 model on the same (bf16-rounded) params."""
    jmodel, jparams, model, params = _pair(
        jax_lm, arch, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    truth_model = LanguageModel(dataclasses.replace(
        model.cfg, dtype=torch.float32, param_dtype=None))
    truth_params = jax.tree.map(lambda x: x, params)
    truth_params = _to_float32(params)
    jbatch, tbatch = _batch(model.cfg, seed=4, t=24)

    def hidden(m, p, batch, kvs_of):
        return m.hidden_states(p, batch["tokens"],
                               prefix_emb=batch.get("prefix_feats"),
                               enc_kvs=kvs_of(m, p, batch))[0]

    def jkvs(m, p, batch):
        if not m.cfg.num_encoder_layers:
            return None
        return m.enc_kvs(p, m.encode(p, batch["enc_feats"]))

    h = hidden(model, params, tbatch, _enc_kvs)
    jh = hidden(jmodel, jparams, jbatch, jkvs)
    true = hidden(truth_model, truth_params, tbatch, _enc_kvs)
    assert h.dtype == torch.bfloat16 and jh.dtype == jnp.bfloat16
    want = true.numpy()
    port_err = _rel_l2(h.float().numpy(), want)
    jax_err = _rel_l2(np.asarray(jh.astype(jnp.float32)), want)
    assert port_err <= jax_err + 2.0 ** -9, (port_err, jax_err)


def _to_float32(tree):
    if isinstance(tree, dict):
        return {k: _to_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_float32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree

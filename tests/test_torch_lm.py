"""The port's recurrentgemma-2b language model against the JAX package's,
at the smoke size on the CPU.

Both packages build the smoke config with ``flash_threshold`` /
``chunk_q`` / ``chunk_k`` lowered, so a 24-token prefill takes the flash
branch of ``attend`` (kernel 10's plain version in the port, the jnp
flash recurrence in JAX) and rolls into the window-8 ring caches.  The
JAX params reach the port through ``convert.convert_lm_params``; inputs
are numpy.  Float32 throughout.  Tolerances: rtol 1e-5 on activations,
hidden states and cache values, with atol 1e-5 of the tensor's largest
magnitude for the entries that cancel towards zero — the JAX RG-LRU runs
an associative scan and the port a sequential loop, and sums run in
other orders; positions, indices and token ids exactly; ``topk_scores``
values at rtol 1e-6.

``test_bfloat16_model_matches`` runs the same comparison with bfloat16
params and activations on both sides (the full config's types) and the
full config's embedding scale √2560, so the bf16 cast points show: the
scaled embedding and the head's logits dtype exactly, the rest at
``bf16_tol``.  That tolerance is one bf16 ulp (2^-8) of each tensor's
largest magnitude for each of the two residual sub-blocks of each layer:
JAX's tanh GELU rounds each of its primitive steps to bfloat16 on this
backend, ``F.gelu`` rounds once, and matrix sums run in other orders, so
every MLP and RG-LRU output may differ by about half an ulp of its scale
and the residual stream carries that from layer to layer.  Decoded ids
there are held to be near-ties: JAX's score of the port's id lies within
``bf16_tol`` of JAX's score at the same rank, relative to the range of
JAX's scores.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import convert_lm_params
from repro_torch.models import attention, layers, recurrent
from repro_torch.models.model import LanguageModel
from torch_reference import jax_lm  # noqa: F401  (fixture)

RTOL = 1e-5
LOWERED = {"flash_threshold": 16, "chunk_q": 8, "chunk_k": 8}
T_PROMPT, MAX_LEN = 24, 40


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def lms(jax_lm):
    jcfg = dataclasses.replace(jax_lm.configs.get_config(
        "recurrentgemma-2b", smoke=True), **LOWERED)
    jmodel = jax_lm.models.LanguageModel(jcfg)
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
    cfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True),
                              **LOWERED)
    model = LanguageModel(cfg)
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jax_lm, jmodel, jparams, model, params


def _prompts(n, t, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, t)).astype(np.int32)


def test_config_and_param_layout_match(lms):
    jax_lm, jmodel, jparams, model, params = lms
    jcfg, cfg = jmodel.cfg, model.cfg
    assert cfg.param_count_estimate() == jcfg.param_count_estimate()
    full = get_config("recurrentgemma-2b")
    jfull = jax_lm.configs.get_config("recurrentgemma-2b")
    assert full.param_count_estimate() == jfull.param_count_estimate() \
        == 2_936_376_320
    assert full.layout() == jfull.layout()
    assert full.mach.num_buckets == 2048 and full.mach.num_repetitions == 8
    assert full.dtype == torch.bfloat16 and full.param_dtype == torch.bfloat16
    for f in dataclasses.fields(jcfg):
        if f.name not in ("mach", "dtype", "param_dtype"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    # leaf for leaf: same tree, shapes and dtypes
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    assert sum(int(np.prod(x.shape)) for _, x in flat) == \
        sum(t.numel() for t in _leaves(params))
    with pytest.raises(ValueError, match="keys"):
        bad = jax.tree.map(np.asarray, jparams)
        del bad["final_norm"]
        convert_lm_params(model, bad, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        bad = jax.tree.map(np.asarray, jparams)
        bad["final_norm"]["scale"] = np.zeros(3, np.float32)
        convert_lm_params(model, bad, device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_layers_match(lms):
    jax_lm, jmodel, jparams, model, params = lms
    jl, jr, ja = jax_lm.layers, jax_lm.recurrent, jax_lm.attention
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    blk_j = jax.tree.map(lambda v: v[0], jparams["stacks"][0][0])   # rglru
    p_r = _index(params["stacks"][0][0], 0)
    _close(layers.apply_norm(p_r["norm1"], _t(x)),
           jl.apply_norm(blk_j["norm1"], jnp.asarray(x)))
    _close(layers.apply_mlp(p_r["mlp"], _t(x), "geglu"),
           jl.apply_mlp(blk_j["mlp"], jnp.asarray(x), "geglu"))
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1)) + 5
    q = rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
    _close(layers.rope(_t(q), _t(pos)), jl.rope(jnp.asarray(q), jnp.asarray(pos)))
    # causal conv, with and without a tail; the RG-LRU block with a state
    tail = rng.standard_normal((2, 3, 64)).astype(np.float32)
    for tl in (None, tail):
        got, got_tail = recurrent._causal_conv(
            p_r["rglru"]["conv"], _t(x), None if tl is None else _t(tl))
        want, want_tail = jr._causal_conv(
            blk_j["rglru"]["conv"], jnp.asarray(x),
            None if tl is None else jnp.asarray(tl))
        _close(got, want)
        _close(got_tail, want_tail)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    state = recurrent.RecurrentState(_t(tail), _t(h0))
    got, got_state = recurrent.apply_rglru_block(p_r["rglru"], _t(x), state)
    want, want_state = jax.jit(jr.apply_rglru_block)(
        blk_j["rglru"], jnp.asarray(x), jr.RecurrentState(jnp.asarray(tail),
                                                          jnp.asarray(h0)))
    _close(got, want)
    _close(got_state.conv, want_state.conv)
    _close(got_state.h, want_state.h)
    # attend: dense and flash branches, windowed and not
    k = rng.standard_normal((2, 24, 1, 32)).astype(np.float32)
    v = rng.standard_normal((2, 24, 1, 32)).astype(np.float32)
    ar = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    for window in (None, 8):
        for thr in (1 << 30, 16):
            got = attention.attend(_t(q), _t(k), _t(v), _t(ar), _t(ar),
                                   window=window, flash_threshold=thr,
                                   chunk_q=8)
            want = ja.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(ar), jnp.asarray(ar), window=window,
                             flash_threshold=thr, chunk_q=8, chunk_k=8)
            _close(got, want)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _check_caches(got, want):
    for g_st, w_st in zip(got, want):
        for g, w in zip(g_st, w_st):
            for name in g._fields:
                gv, wv = getattr(g, name), getattr(w, name)
                if name in ("positions", "index"):
                    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
                else:
                    _close(gv, wv)


def test_prefill_decode_and_decode_heads_match(lms):
    """Prefill (flash branch, ring roll), then eight per-slot decode
    steps: hidden states, caches, greedy ids and top-k after each."""
    jax_lm, jmodel, jparams, model, params = lms
    # the JAX side jitted (eager JAX compiles every small op: minutes)
    hidden_j = jax.jit(lambda p, t: jmodel.hidden_states(p, t)[0])
    prefill_j = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, MAX_LEN))
    decode_j = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, c, None, t, pos, per_slot=True))
    next_j = jax.jit(lambda p, h: jmodel.next_token(p, h)[0])
    toks = _prompts(2, T_PROMPT, 256)
    h_j = hidden_j(jparams, jnp.asarray(toks))
    h_t, _ = model.hidden_states(params, _t(toks))
    _close(h_t, h_j)
    caches_j, _, last_j = prefill_j(jparams, jnp.asarray(toks))
    caches_t, last_t = model.prefill(params, _t(toks).long(), MAX_LEN)
    _close(last_t, last_j)
    assert caches_t[0][2].k.shape[2] == 8            # the window-8 ring
    _check_caches(caches_t, caches_j)
    pos = np.array([T_PROMPT, T_PROMPT], np.int32)
    ids_j = next_j(jparams, last_j)
    ids_t, _ = model.next_token(params, last_t)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    for step in range(8):
        tok = np.asarray(ids_j)
        caches_j, h_j = decode_j(jparams, caches_j, jnp.asarray(tok),
                                 jnp.asarray(pos))
        caches_t, h_t = model.decode_step(params, caches_t, _t(tok).long(),
                                          _t(pos).long(), per_slot=True)
        _close(h_t, h_j)
        _check_caches(caches_t, caches_j)
        ids_j = next_j(jparams, h_j)
        ids_t, _ = model.next_token(params, h_t)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        pos = pos + 1
    for est in ("unbiased", "min", "median"):
        vj, ij = jax.jit(lambda p, h: jmodel.topk_scores(p, h, 10, est))(
            jparams, h_j)
        vt, it = model.topk_scores(params, h_t, 10, est)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        _close(vt, vj, rtol=1e-6)


def test_full_attention_linear_cache_and_lockstep_decode_match(jax_lm):
    """The ``attn`` block kind (no window): a linear KV cache filled by
    prefill, then lockstep decode steps (every row at row 0's index)."""
    from repro.core.mach import MACHConfig as JaxMACHConfig
    from repro_torch.core.mach import MACHConfig
    from repro_torch.models import ModelConfig
    shape = dict(name="t", num_layers=2, d_model=32, num_heads=4,
                 num_kv_heads=2, d_ff=64, vocab_size=128)
    jcfg = jax_lm.models.ModelConfig(**shape, dtype=jnp.float32,
                                     mach=JaxMACHConfig(128, 16, 4))
    jmodel = jax_lm.models.LanguageModel(jcfg)
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(3))
    model = LanguageModel(ModelConfig(**shape, dtype=torch.float32,
                                      mach=MACHConfig(128, 16, 4)))
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    toks = _prompts(2, 7, 128, seed=4)
    caches_j, _, h_j = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, 16))(jparams, jnp.asarray(toks))
    caches_t, h_t = model.prefill(params, _t(toks).long(), 16)
    assert caches_t[0][0].k.shape[2] == 16            # linear, max_len rows
    _close(h_t, h_j)
    _check_caches(caches_t, caches_j)
    decode_j = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, None, t,
                                                               pos))
    next_j = jax.jit(lambda p, h: jmodel.next_token(p, h)[0])
    pos = np.array([7, 7], np.int32)
    for _ in range(3):
        tok = np.asarray(next_j(jparams, h_j))
        np.testing.assert_array_equal(model.next_token(params, h_t)[0].numpy(),
                                      tok)
        caches_j, h_j = decode_j(jparams, caches_j, jnp.asarray(tok),
                                 jnp.asarray(pos))
        caches_t, h_t = model.decode_step(params, caches_t, _t(tok).long(),
                                          _t(pos).long())
        _close(h_t, h_j)
        _check_caches(caches_t, caches_j)
        pos = pos + 1


def bf16_tol(num_layers: int) -> float:
    return 2 * num_layers * 2.0 ** -8


@pytest.fixture(scope="module")
def lms_bf16(jax_lm):
    bf16 = dict(LOWERED, embed_scale=math.sqrt(2560.0))
    jcfg = dataclasses.replace(jax_lm.configs.get_config(
        "recurrentgemma-2b", smoke=True), dtype=jnp.bfloat16,
        param_dtype=jnp.bfloat16, **bf16)
    jmodel = jax_lm.models.LanguageModel(jcfg)
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
    cfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True),
                              dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                              **bf16)
    model = LanguageModel(cfg)
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


def _t32(x):
    """A JAX array (bfloat16 included) as a torch tensor of its dtype."""
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x)


def _close_bf16(got, want, tol):
    assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)
    _close(got.float(), np.asarray(want).astype(np.float32), rtol=tol)


def _near_ties(ids_t, jmodel, jparams, h_j, k, est, tol):
    """JAX's score of each of the port's ids is within ``tol`` of JAX's
    score at the same rank, relative to the range of JAX's scores."""
    vocab = jmodel.cfg.vocab_size
    vals, ids = jax.jit(lambda p, h: jmodel.topk_scores(p, h, vocab, est))(
        jparams, h_j)
    vals, ids = np.asarray(vals, np.float32), np.asarray(ids)
    for row, got in enumerate(ids_t.reshape(len(vals), -1).numpy()):
        score = dict(zip(ids[row].tolist(), vals[row].tolist()))
        mine = np.array([score[int(i)] for i in got])
        span = vals[row].max() - vals[row].min()
        assert np.all(mine >= vals[row, :k] - tol * span), (row, got, ids[row, :k])


def test_bfloat16_model_matches(lms_bf16):
    """The bf16 cast points: prefill (flash branch, ring roll), eight
    per-slot decode steps fed JAX's tokens, the decode heads."""
    jmodel, jparams, model, params = lms_bf16
    tol = bf16_tol(model.cfg.num_layers)
    toks = _prompts(2, T_PROMPT, 256)
    emb_j = jax.jit(jmodel._embed_tokens)(jparams, jnp.asarray(toks))
    emb_t = model._embed_tokens(params, _t(toks).long())
    assert emb_t.dtype == torch.bfloat16
    assert torch.equal(emb_t, _t32(emb_j))          # √2560 rounded to bf16
    prefill_j = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, MAX_LEN))
    decode_j = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, c, None, t, pos, per_slot=True))
    next_j = jax.jit(lambda p, h: jmodel.next_token(p, h)[0])
    caches_j, _, h_j = prefill_j(jparams, jnp.asarray(toks))
    caches_t, h_t = model.prefill(params, _t(toks).long(), MAX_LEN)
    _close_bf16(h_t, h_j, tol)
    for g_st, w_st in zip(caches_t, caches_j):
        for g, w in zip(g_st, w_st):
            for name in g._fields:
                gv, wv = getattr(g, name), getattr(w, name)
                if name in ("positions", "index"):
                    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
                else:
                    _close_bf16(gv, wv, tol)
    # the head's logits in bf16 from the same hidden state
    logits_j = jax.jit(jmodel.mach_logits)(jparams, h_j)
    logits_t = model.mach_logits(params, _t32(h_j))
    _close_bf16(logits_t, logits_j, 2.0 ** -9)
    pos = np.array([T_PROMPT, T_PROMPT], np.int32)
    for step in range(9):
        ids_t, _ = model.next_token(params, h_t)
        _near_ties(ids_t, jmodel, jparams, h_j, 1, "unbiased", tol)
        if step == 8:
            break
        tok = np.asarray(next_j(jparams, h_j))
        caches_j, h_j = decode_j(jparams, caches_j, jnp.asarray(tok),
                                 jnp.asarray(pos))
        caches_t, h_t = model.decode_step(params, caches_t, _t(tok).long(),
                                          _t(pos).long(), per_slot=True)
        _close_bf16(h_t, h_j, tol)
        pos = pos + 1
    for est in ("unbiased", "min", "median"):
        vj, _ = jax.jit(lambda p, h: jmodel.topk_scores(p, h, 10, est))(
            jparams, h_j)
        vt, it = model.topk_scores(params, h_t, 10, est)
        _close(vt, vj, rtol=tol)
        _near_ties(it, jmodel, jparams, h_j, 10, est, tol)

"""The encoder-decoder pieces (the ``enc`` and ``xattn`` blocks,
``cross_kv``, ``encode`` / ``enc_kvs``) and the flash branch's
cross-attention against the JAX package's, float32 on the CPU.

Blocks and attention equal JAX's at rtol 1e-5 plus atol 1e-5 of the
largest entry, on the dense branch and, with ``flash_threshold`` lowered,
on the flash branch, where the cross-attention's S differs from T (S a
multiple of ``chunk_k``: JAX's flash recurrence skips the last
S mod chunk_k keys past one chunk, ROADMAP.md §3; the port reads every
key).  The flash branch refuses S != T with a causal mask or a window.
Prefill then decode equals the full forward for an enc-dec and an xLSTM
model, as ``tests/test_models.py`` holds the JAX package (its configs;
the decode path's recurrent and cached forms sum in other orders than
the full forward's, so the bound is rtol 1e-4 plus atol 1e-5 of the
largest entry).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import convert_lm_params
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer
from repro_torch.models.model import LanguageModel
from repro_torch.models.transformer import ModelConfig
from torch_reference import jax_lm  # noqa: F401  (fixture)

RTOL = 1e-5
ARCH = "seamless-m4t-large-v2"
LOWERED = {"flash_threshold": 8, "chunk_q": 8, "chunk_k": 8}


def _close(got, want, rtol=RTOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return _t(np.asarray(x))


def _cfgs(jax_lm, **overrides):
    return (dataclasses.replace(get_config(ARCH, smoke=True), **overrides),
            dataclasses.replace(jax_lm.configs.get_config(ARCH, smoke=True),
                                **overrides))


@pytest.mark.parametrize("lowered", (False, True), ids=("dense", "flash"))
@pytest.mark.parametrize("kind", ("enc", "xattn"))
def test_blocks_match_jax(jax_lm, kind, lowered):
    """One ``enc`` block (non-causal self-attention at positions 0..T-1) or
    ``xattn`` block (causal self-attention, then cross-attention over
    ``cross_kv`` of an encoder output of S=24 frames) against JAX's."""
    cfg, jcfg = _cfgs(jax_lm, **(LOWERED if lowered else {}))
    jt = jax_lm.transformer
    jp, _ = jt.init_block(jax.random.key(2), jcfg, kind)
    params = _tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    b, t, s = 2, 16, 24
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    jkv = jt.cross_kv(jp, jnp.asarray(enc)) if kind == "xattn" else None
    kv = transformer.cross_kv(params, _t(enc)) if kind == "xattn" else None
    if kind == "xattn":
        for got, want in zip(kv, jkv):
            _close(got, want)
    jy, _, _ = jt.apply_block(jp, jcfg, kind, jnp.asarray(x),
                              jnp.asarray(pos), enc_kv=jkv)
    y, _, aux = transformer.apply_block(params, cfg, kind, _t(x), _t(pos),
                                        enc_kv=kv)
    assert aux == {}
    _close(y, jy)


@pytest.mark.parametrize("b,t,s,h,kv", [(2, 16, 24, 4, 4), (1, 8, 32, 4, 2),
                                        (2, 24, 8, 4, 1)])
def test_flash_cross_attention_matches_jax(jax_lm, b, t, s, h, kv):
    """``attend`` over all-zero positions, non-causal, no window, S != T on
    the flash branch (kernel 10's plain version on the CPU) and on the
    dense branch, against JAX's ``attend``."""
    rng = np.random.default_rng(t + s)
    hd = 16
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    qp, kp = np.zeros((b, t), np.int32), np.zeros((b, s), np.int32)
    ja = jax_lm.attention
    want = ja.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(qp), jnp.asarray(kp), causal=False,
                     window=None, **LOWERED)
    for kw in (dict(flash_threshold=8, chunk_q=8), {}):
        got = attn_lib.attend(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                              causal=False, window=None, **kw)
        _close(got, want)


def test_flash_branch_refuses_masked_s_ne_t():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 16, 2, 16))
    pos = torch.zeros((1, 8), dtype=torch.int32)
    kpos = torch.zeros((1, 16), dtype=torch.int32)
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="S != T"):
            attn_lib.attend(q, k, k, pos, kpos, flash_threshold=8, chunk_q=8,
                            **kw)


@pytest.mark.parametrize("lowered", (False, True), ids=("dense", "flash"))
def test_encode_and_enc_kvs_match_jax(jax_lm, lowered):
    """The smoke model's ``encode`` (adapter, 2 ``enc`` layers, norm) and
    ``enc_kvs`` (stacked on the layer axis, a loop where JAX vmaps)."""
    cfg, jcfg = _cfgs(jax_lm, **(LOWERED if lowered else {}))
    jmodel = jax_lm.models.LanguageModel(jcfg)
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
    model = LanguageModel(cfg)
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    feats = np.random.default_rng(4).standard_normal(
        (2, 16, 1024)).astype(np.float32)
    jout = jmodel.encode(jparams, jnp.asarray(feats))
    out = model.encode(params, _t(feats))
    _close(out, jout)
    jkvs = jmodel.enc_kvs(jparams, jout)
    kvs = model.enc_kvs(params, out)
    assert len(kvs) == len(jkvs)
    for st, jst in zip(kvs, jkvs):
        for (k, v), (jk, jv) in zip(st, jst):
            assert k.shape == jk.shape == (cfg.num_layers, 2, 16,
                                           cfg.num_kv_heads,
                                           cfg.resolved_head_dim)
            _close(k, jk)
            _close(v, jv)


BASE = dict(d_model=64, num_heads=4, d_ff=128, vocab_size=100,
            dtype=torch.float32, scan_layers=True)


def _decode_consistency(cfg, enc_feats=None):
    """Full forward == prefill + three decode steps (the JAX package's
    ``tests/test_models.py`` check, on the port)."""
    m = LanguageModel(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    b, t = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (b, t),
                         generator=torch.Generator().manual_seed(5))
    enc_kvs = None
    if cfg.num_encoder_layers:
        enc_kvs = m.enc_kvs(params, m.encode(params, enc_feats))
    h_full, _, _ = m.hidden_states(params, toks, enc_kvs=enc_kvs)
    p = t - 3
    caches, h_last = m.prefill(params, toks[:, :p], t + 4, enc_kvs=enc_kvs)
    _close(h_last, h_full[:, p - 1].numpy(), rtol=1e-4)
    for i in range(3):
        pos = torch.full((b,), p + i, dtype=torch.int32)
        caches, h = m.decode_step(params, caches, toks[:, p + i], pos,
                                  enc_kvs=enc_kvs)
        _close(h, h_full[:, p + i].numpy(), rtol=1e-4)


def test_decode_consistency_enc_dec():
    _decode_consistency(
        ModelConfig(name="ed", num_layers=2, num_kv_heads=4,
                    family="enc_dec", num_encoder_layers=2, frontend="audio",
                    **BASE),
        torch.randn((2, 9, 1024), generator=torch.Generator().manual_seed(7)))


def test_decode_consistency_xlstm():
    _decode_consistency(ModelConfig(name="xl", num_layers=4, num_kv_heads=4,
                                    family="xlstm",
                                    block_pattern=("mlstm", "slstm"), **BASE))

"""The xLSTM blocks (``models/xlstm.py``) against the JAX package's, on the
same numpy inputs and params, float32 on the CPU.

The mLSTM's parallel, chunkwise (chunks 16, 32, 64 and T, and a T that
is no multiple of 64) and step forms each equal JAX's at rtol 1e-5 plus
atol 1e-5 of the largest entry; inside the port the chunkwise form
equals the parallel one and its final state the step recurrence's, at
the JAX package's own tolerances for those identities
(``tests/test_models.py``: the forms sum in other orders and the state
is a product of T decays).  Both blocks prefill from the initial state
and then decode from the carried state as JAX's do, a given state
updated in place.  A smoke xLSTM model's states take the per-slot copy
path of the contiguous and paged pools and are reset to their initial
values (m at −1e30, the sLSTM's n at 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import xlstm
from repro_torch.models.model import LanguageModel
from torch_reference import jax_lm  # noqa: F401  (fixture)

RTOL = 1e-5
B, T, H, HD = 2, 128, 4, 16


def _close(got, want, rtol=RTOL, atol=None) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if atol is None:
        atol = RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _tree(x):
    """A JAX params tree as the port's dict of tensors."""
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return _t(np.asarray(x))


def _mlstm_inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, t, H, HD)).astype(np.float32)
               for _ in range(3))
    li = (rng.standard_normal((B, t, H)) * 0.5).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        jnp.asarray(rng.standard_normal((B, t, H)) + 2.0, jnp.float32)))
    return q, k, v, li, lf


def test_mlstm_parallel_matches_jax(jax_lm):
    arrays = _mlstm_inputs(T)
    got = xlstm._mlstm_parallel(*map(_t, arrays))
    _close(got, jax_lm.xlstm._mlstm_parallel(*map(jnp.asarray, arrays)))


@pytest.mark.parametrize("t,chunk", [(T, 16), (T, 32), (T, 64), (T, T),
                                     (80, 16), (80, 80)])
def test_mlstm_chunkwise_matches_jax_and_parallel(jax_lm, t, chunk):
    arrays = _mlstm_inputs(t, seed=t + chunk)
    jx = jax_lm.xlstm
    jh, jst = jx._mlstm_chunkwise(*map(jnp.asarray, arrays),
                                  jx.init_mlstm_state(B, H, HD), chunk=chunk)
    h, st = xlstm._mlstm_chunkwise(*map(_t, arrays),
                                   xlstm.init_mlstm_state(B, H, HD), chunk)
    _close(h, jh)
    for got, want in zip(st, jst):
        _close(got, want)
    _close(h, xlstm._mlstm_parallel(*map(_t, arrays)).numpy(), rtol=2e-4,
           atol=2e-5)


def test_mlstm_step_matches_jax_and_chunkwise_state(jax_lm):
    arrays = _mlstm_inputs(T, seed=3)
    q, k, v, li, lf = map(_t, arrays)
    jq, jk, jv, jli, jlf = map(jnp.asarray, arrays)
    jx = jax_lm.xlstm
    st, jst = xlstm.init_mlstm_state(B, H, HD), jx.init_mlstm_state(B, H, HD)
    for i in range(T):
        st, h = xlstm._mlstm_step(st, q[:, i], k[:, i], v[:, i], li[:, i],
                                  lf[:, i])
        jst, jh = jx._mlstm_step(jst, jq[:, i], jk[:, i], jv[:, i], jli[:, i],
                                 jlf[:, i])
        _close(h, jh)
    for got, want in zip(st, jst):
        _close(got, want)
    _, st_ck = xlstm._mlstm_chunkwise(q, k, v, li, lf,
                                      xlstm.init_mlstm_state(B, H, HD), 32)
    for a, b in zip(st_ck, st):
        _close(a, b.numpy(), rtol=2e-3, atol=1e-4)


def test_mlstm_chunk_rule():
    """256 when T > 256 and 256 | T, else 64 when T > 64 and 64 | T, else T
    (``repro/models/xlstm.py``'s apply_mlstm_block)."""
    assert [xlstm.mlstm_chunk(t) for t in (1, 12, 64, 80, 128, 256, 320, 512,
                                           2048, 1000)] == \
        [1, 12, 64, 80, 64, 64, 64, 256, 256, 1000]


def _block_pair(jax_lm, kind, d=32):
    jx = jax_lm.xlstm
    key = jax.random.key(1)
    if kind == "mlstm":
        jp, _ = jx.init_mlstm_block(key, d, H, 2.0)
        return jp, _tree(jax.tree.map(np.asarray, jp)), \
            jx.apply_mlstm_block, xlstm.apply_mlstm_block
    jp, _ = jx.init_slstm_block(key, d, H)
    return jp, _tree(jax.tree.map(np.asarray, jp)), \
        jx.apply_slstm_block, xlstm.apply_slstm_block


@pytest.mark.parametrize("kind,t", [("mlstm", 1), ("mlstm", 12),
                                    ("mlstm", 128), ("mlstm", 512),
                                    ("slstm", 1), ("slstm", 12),
                                    ("slstm", 128)])
def test_block_prefill_then_decode_matches_jax(jax_lm, kind, t):
    """Prefill from the initial state (``state=None``; a one-token prompt
    prefills, not steps), then three decode steps from the carried state;
    outputs and states equal JAX's, and a passed state is updated in
    place.  The mLSTM's T cover its chunk rule (T, 64 and 256)."""
    jp, params, japply, apply = _block_pair(jax_lm, kind)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((B, t + 3, 32)).astype(np.float32)
    jy, jst = japply(jp, jnp.asarray(x[:, :t]))
    y, st = apply(params, _t(x[:, :t]))
    _close(y, jy)
    for got, want in zip(st, jst):
        _close(got, want)
    for i in range(3):
        xi = x[:, t + i:t + i + 1]
        jy, jst = japply(jp, jnp.asarray(xi), jst, decode=True)
        ptrs = [f.data_ptr() for f in st]
        y, st2 = apply(params, _t(xi), st, decode=True)
        assert st2 is st and [f.data_ptr() for f in st] == ptrs
        _close(y, jy)
        for got, want in zip(st, jst):
            _close(got, want)


def test_initial_states_match_jax(jax_lm):
    jx = jax_lm.xlstm
    for got, want in ((xlstm.init_mlstm_state(2, 3, 4),
                       jx.init_mlstm_state(2, 3, 4)),
                      (xlstm.init_slstm_state(2, 3, 4),
                       jx.init_slstm_state(2, 3, 4))):
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("paged", (False, True), ids=("contiguous", "paged"))
def test_states_copy_per_slot_and_reset(paged):
    """An xLSTM model's states take the contiguous per-slot copy in both
    pool layouts, and a freed slot is restored to the initial values."""
    model = LanguageModel(get_config("xlstm-350m", smoke=True))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    fresh = model.init_caches(3, 16, device="cpu")
    pool = (model.init_paged_caches(3, 16, 4, 12, device="cpu") if paged
            else model.init_caches(3, 16, device="cpu"))
    assert [type(c).__name__ for st in pool for c in st] == \
        ["MLSTMState", "SLSTMState"]
    one, _ = model.prefill(params, torch.tensor([[5, 6, 7, 8, 9]]), 16)
    if paged:
        model.insert_cache_slot_paged(pool, one, 1, torch.tensor([0, 1]))
    else:
        model.insert_cache_slot(pool, one, 1)
    for pc, oc, fc in zip(pool[0], one[0], fresh[0]):
        for p, o, f in zip(pc, oc, fc):
            assert torch.equal(p[:, 1], o[:, 0])
            assert torch.equal(p[:, 0], f[:, 0])
            assert torch.equal(p[:, 2], f[:, 0])
    if paged:
        model.reset_cache_slot_paged(pool, 1, 16)
    else:
        model.reset_cache_slot(pool, 1, 16)
    for pc, fc in zip(pool[0], fresh[0]):
        for p, f in zip(pc, fc):
            assert torch.equal(p, f)
    assert bool((pool[0][0].m[:, 1] == -1e30).all())
    assert bool((pool[0][1].n[:, 1] == 1e-6).all())

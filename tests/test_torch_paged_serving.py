"""The port's paged KV cache, page allocator and paged engine against the
JAX package's (``repro/models/attention.py``'s paged cache,
``repro/serving/engine.py``'s paged engine), on the small MACH model of
``tests/test_paged_serving.py`` (d=48, 4/2 heads, V=200, MACH B=16, R=4;
float32, CPU), params carried across by ``convert_lm_params``.

Each test of ``tests/test_paged_serving.py`` has its counterpart here.
The pool ops run on the same numpy inputs in both packages: page
tables, positions and indices must be equal, k/v equal on the pool's
pages (the port's spare page aside), paged attention within rtol 1e-5.
The engines run tick by tick side by side: tokens, the allocator's
gauges, each live slot's page ids, every integer leaf of the pool and
``repr`` must be equal after every tick.  Sampled tokens cannot be
compared across packages (the port's Gumbel noise comes from numpy
streams), so the sampling tests hold the port's paged engine to its
own contiguous engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.core.mach import MACHConfig as JaxMACHConfig
from repro_torch.configs import get_config
from repro_torch.convert import convert_lm_params
from repro_torch.core.mach import MACHConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.model import LanguageModel
from repro_torch.models.transformer import ModelConfig
from repro_torch.serving import (Request, SamplingParams, ServeConfig,
                                 ServingEngine)
from repro_torch.serving.engine import make_serve_step_fn
from torch_reference import jax_lm  # noqa: F401  (fixture)

RTOL = {"rtol": 1e-5, "atol": 1e-6}
SMALL = dict(name="srv-paged", num_layers=2, d_model=48, num_heads=4,
             num_kv_heads=2, d_ff=96, vocab_size=200)
RAGGED = [([1, 2, 3], 6), ([4, 5], 2), ([6, 7, 8, 9], 6), ([10], 2),
          ([11, 12, 13, 14, 15, 16, 17], 8), ([18, 19], 4)]
ENGINE = dict(max_len=32, num_slots=3, max_new_tokens=6, page_size=4)


def _pair(jax_lm, jcfg, cfg):
    jmodel = jax_lm.models.LanguageModel(jcfg)
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
    model = LanguageModel(cfg)
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jax_lm, jmodel, jparams, model, params


@pytest.fixture(scope="module")
def served(jax_lm):
    return _pair(jax_lm,
                 jax_lm.models.ModelConfig(**SMALL, dtype=jnp.float32,
                                           mach=JaxMACHConfig(200, 16, 4)),
                 ModelConfig(**SMALL, dtype=torch.float32,
                             mach=MACHConfig(200, 16, 4)))


# ---------------------------------------------------------------------------
# pool ops on the same numpy inputs
# ---------------------------------------------------------------------------

def _toy_contiguous(cap=8, prompt_len=6, seed=0):
    """A batch-1 contiguous cache as the engine's prefill builds it, as
    numpy arrays (k, v, positions, index)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((1, cap, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, cap, 2, 8)).astype(np.float32)
    pos = np.where(np.arange(cap) < prompt_len, np.arange(cap), -1)
    return k, v, pos[None].astype(np.int32), np.asarray([prompt_len], np.int32)


def _caches(ja, arrays):
    """The same contiguous cache in both packages."""
    return (ja.KVCache(*(jnp.asarray(a) for a in arrays)),
            attn_lib.KVCache(*(torch.from_numpy(a.copy()) for a in arrays)))


def _pools(ja, num_slots, num_pages, page_size, max_pages):
    return (ja.init_paged_cache(num_slots, num_pages, page_size, max_pages,
                                2, 8, dtype=jnp.float32),
            attn_lib.init_paged_cache(num_slots, num_pages, page_size,
                                      max_pages, 2, 8, torch.float32, "cpu"))


def _assert_pool_equal(pool, jpool, contents=True):
    """Integer leaves exactly; k / v of the pool's pages (not the port's
    spare page) exactly unless ``contents`` is False."""
    n = jpool.k.shape[-4]
    assert pool.num_pages == n and pool.max_pages == jpool.page_table.shape[-1]
    np.testing.assert_array_equal(pool.page_table.numpy(),
                                  np.asarray(jpool.page_table))
    np.testing.assert_array_equal(pool.index.numpy(), np.asarray(jpool.index))
    np.testing.assert_array_equal(pool.positions[..., :n, :].numpy(),
                                  np.asarray(jpool.positions))
    if contents:
        np.testing.assert_array_equal(pool.k[..., :n, :, :, :].numpy(),
                                      np.asarray(jpool.k))
        np.testing.assert_array_equal(pool.v[..., :n, :, :, :].numpy(),
                                      np.asarray(jpool.v))


def test_paged_insert_then_attend_matches_jax_and_contiguous(jax_lm):
    """A batch-1 strip inserted into unordered pool pages: the pool equals
    JAX's, and paged attention equals JAX's and the contiguous cache's
    dense attention for the owning slot."""
    ja = jax_lm.attention
    jone, one = _caches(ja, _toy_contiguous())
    jpool, pool = _pools(ja, 3, 5, 4, 4)
    jpool = ja.paged_insert_prefill(jpool, jone, 1,
                                    jnp.asarray([3, 1], jnp.int32))
    attn_lib.paged_insert_prefill(pool, one, 1, torch.tensor([3, 1]))
    _assert_pool_equal(pool, jpool)
    assert pool.index.tolist() == [0, 6, 0]
    assert pool.page_table[1].tolist() == [3, 1, -1, -1]

    q = np.random.default_rng(9).standard_normal((3, 1, 4, 8)).astype(
        np.float32)
    got = attn_lib.paged_decode_attend(torch.from_numpy(q), pool)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ja.paged_decode_attend(jnp.asarray(q), jpool)),
        **RTOL)
    want = attn_lib.decode_attend(torch.from_numpy(q[1:2]), one)
    np.testing.assert_allclose(got[1].numpy(), want[0].numpy(), atol=1e-5)


def test_paged_decode_write_matches_jax_and_contiguous(jax_lm):
    ja = jax_lm.attention
    arrays = _toy_contiguous()
    jone, one = _caches(ja, arrays)
    jpool, pool = _pools(ja, 3, 5, 4, 4)
    jpool = ja.paged_insert_prefill(jpool, jone, jnp.asarray(1),
                                    jnp.asarray([0, 2], jnp.int32))
    attn_lib.paged_insert_prefill(pool, one, 1, torch.tensor([0, 2]))
    rng = np.random.default_rng(3)
    k_all = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    v_all = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    jpool = ja.paged_cache_update_decode(jpool, jnp.asarray(k_all),
                                         jnp.asarray(v_all))
    attn_lib.paged_cache_update_decode(pool, torch.from_numpy(k_all),
                                       torch.from_numpy(v_all))
    _assert_pool_equal(pool, jpool)
    assert pool.index.tolist() == [1, 7, 1]        # every index advances
    assert (pool.page_table[[0, 2]] == -1).all()   # free slots stay inert

    attn_lib.cache_update_decode(one, torch.from_numpy(k_all[1:2]),
                                 torch.from_numpy(v_all[1:2]), ring=False,
                                 per_row=True)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    got = attn_lib.paged_decode_attend(torch.from_numpy(q), pool)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ja.paged_decode_attend(jnp.asarray(q), jpool)),
        **RTOL)
    want = attn_lib.decode_attend(torch.from_numpy(q[1:2]), one)
    np.testing.assert_allclose(got[1].numpy(), want[0].numpy(), atol=1e-5)


def test_recycled_page_stale_positions_masked(jax_lm):
    """A freed page keeps its contents; the next decode write at page
    offset 0 rewrites the whole position row, in both packages."""
    ja = jax_lm.attention
    jone, one = _caches(ja, _toy_contiguous(cap=4, prompt_len=4))
    jpool, pool = _pools(ja, 2, 3, 4, 2)
    jpool = ja.paged_insert_prefill(jpool, jone, jnp.asarray(0),
                                    jnp.asarray([1], jnp.int32))
    attn_lib.paged_insert_prefill(pool, one, 0, torch.tensor([1]))
    assert pool.positions[1].tolist() == [0, 1, 2, 3]
    jpool = ja.paged_reset_slot(jpool, jnp.asarray(0))
    attn_lib.paged_reset_slot(pool, 0)
    _assert_pool_equal(pool, jpool)
    assert pool.positions[1].tolist() == [0, 1, 2, 3]  # stale, by design

    # slot 1 (a fresh request, index 0) is handed recycled page 1
    jpool = jpool._replace(index=jpool.index.at[1].set(0))
    pool.index[1] = 0
    jpool = ja.paged_append_page(jpool, jnp.asarray(1), jnp.asarray(0),
                                 jnp.asarray(1))
    attn_lib.paged_append_page(pool, 1, 0, 1)
    ones = np.ones((2, 1, 2, 8), np.float32)
    jpool = ja.paged_cache_update_decode(jpool, jnp.asarray(ones),
                                         jnp.asarray(ones))
    attn_lib.paged_cache_update_decode(pool, torch.from_numpy(ones),
                                       torch.from_numpy(ones))
    _assert_pool_equal(pool, jpool)
    assert pool.positions[1].tolist() == [0, -1, -1, -1]


# ---------------------------------------------------------------------------
# engines tick by tick
# ---------------------------------------------------------------------------

def _tick_state(eng, results):
    """What must agree across packages after a tick."""
    m = eng.metrics
    pool = [(np.asarray(c.page_table).copy(), np.asarray(c.index).copy(),
             np.asarray(c.positions)[..., :eng._num_pages, :].copy())
            for stack in eng._pool for c in stack if hasattr(c, "page_table")]
    return {"results": [(r.request_id, tuple(int(t) for t in r.tokens),
                         r.finish_reason, r.latency_steps) for r in results],
            "gauges": (m.decode_steps, m.prefills, m.tokens_generated,
                       m.completed, m.live_slot_steps, m.peak_live_slots,
                       m.num_pages, m.pages_in_use, m.pages_reserved,
                       m.pages_peak, m.reservation_failures, m.fragmentation),
            "pages": {s.req_id: tuple(s.pages) for s in eng._slots
                      if s is not None},
            "free": tuple(getattr(eng, "_free_pages", ())),
            "pool": pool, "repr": repr(eng)}


def _trace(eng, requests):
    """Submit, then tick to the end, recording ``_tick_state`` and
    checking that no page is owned twice or both owned and free."""
    for r in requests:
        eng.submit(r)
    trace = []
    while eng.queue_depth or any(s is not None for s in eng._slots):
        trace.append(_tick_state(eng, eng.step()))
        owned = [p for pages in trace[-1]["pages"].values() for p in pages]
        assert len(owned) == len(set(owned))
        if eng.scfg.paged:
            assert not set(owned) & set(eng._free_pages)
            assert len(owned) + len(eng._free_pages) == eng._num_pages
    return trace


def _both(served, reqs, **kw):
    """The same (prompt, max_new) requests through the port's engine and
    the JAX package's, tick by tick: (port trace, JAX trace, port
    engine)."""
    jax_lm, jmodel, jparams, model, params = served
    cfg = dict(ENGINE, **kw)
    js = jax_lm.serving
    eng = ServingEngine(model, params, ServeConfig(**cfg))
    jeng = js.ServingEngine(jmodel, jparams, js.ServeConfig(**cfg))
    got = _trace(eng, [Request(prompt=p, max_new_tokens=mn)
                       for p, mn in reqs])
    want = _trace(jeng, [js.Request(prompt=p, max_new_tokens=mn)
                         for p, mn in reqs])
    return got, want, eng


def _assert_traces_equal(got, want):
    assert len(got) == len(want)
    for tick, (g, w) in enumerate(zip(got, want)):
        for key in ("results", "gauges", "pages", "free", "repr"):
            assert g[key] == w[key], (tick, key, g[key], w[key])
        assert len(g["pool"]) == len(w["pool"])
        for gl, wl in zip(g["pool"], w["pool"]):
            for a, b in zip(gl, wl):
                np.testing.assert_array_equal(a, b)


def _tokens(trace):
    done = [r for t in trace for r in t["results"]]
    return [list(r[1]) for r in sorted(done)]


def _run(model, params, reqs, **kw):
    eng = ServingEngine(model, params, ServeConfig(**dict(ENGINE, **kw)))
    for r in reqs:
        eng.submit(r)
    return [list(r.tokens) for r in eng.run()], eng


def test_paged_greedy_parity_with_jax_and_contiguous_ragged(served):
    """Greedy tokens on a ragged workload that recycles slots and pages
    mid-decode: the port's paged engine equals the JAX paged engine
    (and its pool, gauges and page ids after every tick) and the port's
    contiguous engine."""
    *_, model, params = served
    got, want, eng = _both(served, RAGGED, num_slots=2, num_pages=8)
    _assert_traces_equal(got, want)
    cont, _ = _run(model, params, [Request(prompt=p, max_new_tokens=mn)
                                   for p, mn in RAGGED],
                   page_size=0, num_slots=2)
    assert _tokens(got) == cont
    assert eng.metrics.prefills == len(RAGGED)


def test_paged_seeded_sampling_parity_with_contiguous(served):
    """Sampled continuations are keyed per request, never per page:
    explicit seeds give the same tokens on both layouts."""
    *_, model, params = served
    reqs = [Request(prompt=p, max_new_tokens=mn,
                    sampling=SamplingParams(temperature=0.9, top_k=8,
                                            seed=50 + i))
            for i, (p, mn) in enumerate(RAGGED)]
    cont, _ = _run(model, params, reqs, page_size=0, num_slots=2)
    paged, _ = _run(model, params, reqs, num_slots=2, num_pages=8)
    assert cont == paged


def test_paged_free_slot_inertness(served):
    """Free slots cannot touch pages they do not own: a lone request in
    a wide engine matches its solo run exactly."""
    *_, model, params = served
    solo, _ = _run(model, params, [Request(prompt=[3, 1, 4])], num_slots=1)
    wide, eng = _run(model, params, [Request(prompt=[3, 1, 4])], num_slots=3)
    assert solo == wide


def test_paged_queue_order_independence(served):
    """An explicitly seeded request's continuation does not depend on
    queue order, and so not on which pages it lands in."""
    *_, model, params = served

    def run_a(order):
        eng = ServingEngine(model, params, ServeConfig(**ENGINE, seed=7))
        rid = None
        for name in order:
            if name == "A":
                rid = eng.submit(Request(prompt=[3, 7], sampling=SamplingParams(
                    temperature=1.3, top_k=8, seed=99)))
            else:
                eng.submit(Request(prompt=[9, 1, 4]))
        return {r.request_id: r.tokens for r in eng.run()}[rid]

    assert run_a("ABC") == run_a("BCA") == run_a("A")


def test_freed_pages_recycled_without_leakage(served):
    """One slot and a pool one request wide: every request after the
    first decodes in recycled pages and still matches its solo run."""
    *_, model, params = served
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
    kw = dict(num_slots=1, num_pages=2, max_new_tokens=4)
    got, eng = _run(model, params,
                    [Request(prompt=p, max_new_tokens=4) for p in prompts],
                    **kw)
    for p, toks in zip(prompts, got):
        solo, _ = _run(model, params, [Request(prompt=p, max_new_tokens=4)],
                       **kw)
        assert [toks] == solo
    assert sorted(eng._free_pages) == [0, 1]


def test_page_allocator_deterministic_fifo_and_alias_free(served):
    """Page ids are handed out FIFO: two runs replay the same
    assignment, equal to the JAX allocator's tick by tick, and pages are
    recycled across requests without ever being shared by two live
    slots (``_trace`` checks that after every tick)."""
    *_, model, params = served
    got, want, _ = _both(served, RAGGED, num_slots=2, num_pages=8)
    again, _, _ = _both(served, RAGGED, num_slots=2, num_pages=8)
    assert [t["pages"] for t in got] == [t["pages"] for t in again] == \
        [t["pages"] for t in want]
    assert got[-1]["free"] == want[-1]["free"]
    owners = {}
    for tick in got:
        for rid, pages in tick["pages"].items():
            for p in pages:
                owners.setdefault(p, set()).add(rid)
    assert any(len(v) > 1 for v in owners.values())


def test_reservation_exhaustion_queues_instead_of_crashing(served):
    """3 pages: one 2-page reservation at a time; four slots stay idle.
    The gauges equal the JAX engine's after every tick."""
    reqs = [([1 + i, 2, 3], 4) for i in range(4)]
    got, want, eng = _both(served, reqs, num_slots=4, num_pages=3,
                           max_new_tokens=4)
    _assert_traces_equal(got, want)
    assert [len(t) for t in _tokens(got)] == [4] * 4
    m = eng.metrics
    assert m.reservation_failures > 0
    assert m.pages_peak <= 3
    assert m.pages_in_use == 0 and m.pages_reserved == 0
    assert m.fragmentation == 0
    assert m.peak_live_slots < 4          # page-bound, not slot-bound


def test_submit_rejects_request_larger_than_pool(served):
    *_, model, params = served
    eng = ServingEngine(model, params, ServeConfig(**ENGINE, num_pages=4))
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(prompt=list(range(1, 15)), max_new_tokens=6))
    # an impossible request must not poison the engine
    eng.submit(Request(prompt=[1, 2], max_new_tokens=2))
    assert len(eng.run()) == 1


def test_lockstep_requires_contiguous_layout(served):
    *_, model, params = served
    with pytest.raises(ValueError, match="lockstep"):
        ServingEngine(model, params, ServeConfig(**ENGINE,
                                                 scheduler="lockstep"))
    outs, _ = _run(model, params, [Request(prompt=[1, 2, 3])], page_size=0,
                   scheduler="lockstep")
    assert len(outs) == 1


def test_paged_metrics_gauges_and_repr(served):
    """Gauges and ``repr`` equal the JAX engine's after every tick."""
    got, want, eng = _both(served, RAGGED[:3], num_slots=2, num_pages=8)
    _assert_traces_equal(got, want)
    m = eng.metrics
    assert m.num_pages == 8 and m.pages_peak > 0
    assert m.pages_in_use == 0 and m.pages_reserved == 0
    assert m.peak_live_slots == 2
    r = repr(eng)
    assert "pages=0/8" in r and "peak=" in r


class _OutputShapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes += [tuple(t.shape) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
        return out


def test_paged_decode_never_materializes_max_len_strip(served):
    """No op output of a paged decode step carries both the slot dim and
    the logical max_len dim: the (num_slots, max_len) strip is what the
    page pool exists to kill.  Dims collide with nothing else in the
    model (d_model=48, 4 heads)."""
    *_, model, params = served
    slots, max_len, page_size = 5, 40, 5
    serve_step = make_serve_step_fn(model, top_k=8)
    pool = model.init_paged_caches(slots, max_len, page_size, 10,
                                   device="cpu")
    # every slot owns pages, so the walk gathers real pages
    for s in range(slots):
        for j in range(max_len // page_size):
            model.append_cache_page(pool, s, j, (s + j) % 10)
    z = [0] * slots
    with _OutputShapes() as rec:
        pool, ids = serve_step(
            params, pool, torch.zeros((slots, 1), dtype=torch.int64),
            torch.zeros(slots, dtype=torch.int64), 0, z, z, [0.9] * slots,
            [4] * slots, z, estimators=("unbiased",), max_len=max_len)
    assert ids.shape == (slots,) and rec.shapes
    bad = [s for s in rec.shapes if slots in s and max_len in s]
    assert not bad, bad


@pytest.fixture(scope="module")
def griffin(jax_lm):
    return _pair(jax_lm, jax_lm.configs.get_config("recurrentgemma-2b",
                                                   smoke=True),
                 get_config("recurrentgemma-2b", smoke=True))


def test_recurrentgemma_mixed_pool_matches_jax(griffin):
    """The smoke recurrentgemma-2b paged at max_len = its local window
    (8): its local-attention caches are paged, its recurrent states stay
    per-slot rows.  Tokens, gauges and the pool's integer leaves equal
    the JAX paged engine's after every tick, and the tokens equal the
    port's contiguous engine's."""
    *_, model, params = griffin
    reqs = [([1, 2, 3], 4), ([4, 5], 2), ([6, 7, 8, 9], 5), ([10], 3),
            ([11, 12], 6)]
    kw = dict(max_len=8, num_slots=2, max_new_tokens=4, page_size=4)
    got, want, eng = _both(griffin, reqs, **kw)
    _assert_traces_equal(got, want)
    kinds = {type(c).__name__ for stack in eng._pool for c in stack}
    assert kinds == {"PagedKVCache", "RecurrentState"}
    cont, _ = _run(model, params, [Request(prompt=p, max_new_tokens=mn)
                                   for p, mn in reqs], **dict(kw, page_size=0))
    assert _tokens(got) == cont

"""The port's continuous-batching engine: greedy tokens against the JAX
package's engine, and the engine's own contract, on the smoke
recurrentgemma-2b (float32, CPU).

Greedy token ids must equal the JAX engine's exactly (same params, same
prompts, 2 slots, 5 requests, EOS).  Sampled tokens cannot: the port
draws its Gumbel noise from numpy streams and JAX from ``fold_in`` keys,
so the sampling tests hold the properties instead — the same seed gives
the same tokens, a request's tokens do not depend on its slot or its
neighbours, explicit seeds and request ids draw from disjoint streams,
and greedy rows are inert.
"""

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import convert_lm_params
from repro_torch.kernels import mach_candidates as mc
from repro_torch.models.model import LanguageModel
from repro_torch.serving import (GenerationResult, Request, SamplingParams,
                                 ServeConfig, ServingEngine)
from torch_reference import jax_lm  # noqa: F401  (fixture)

PROMPTS = [[1, 2, 3], [4, 5, 6], [7, 8], [9, 10, 11], [12, 13]]


@pytest.fixture(scope="module")
def served(jax_lm):
    jcfg = jax_lm.configs.get_config("recurrentgemma-2b", smoke=True)
    jmodel = jax_lm.models.LanguageModel(jcfg)
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
    model = LanguageModel(get_config("recurrentgemma-2b", smoke=True))
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jax_lm, jmodel, jparams, model, params


def _engine(model, params, **kw):
    kw.setdefault("max_len", 32)
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_new_tokens", 6)
    return ServingEngine(model, params, ServeConfig(**kw))


def _run(eng, prompts, **req_kw):
    for p in prompts:
        eng.submit(Request(prompt=p, **req_kw))
    return eng.run()


def _reference_decode(model, params, prompt, n, max_len=32):
    """Per-request greedy decode straight off the model API."""
    caches, h = model.prefill(params, torch.tensor([prompt]), max_len)
    toks = [int(model.next_token(params, h)[0][0])]
    for pos in range(len(prompt), len(prompt) + n - 1):
        caches, h = model.decode_step(params, caches, torch.tensor(toks[-1:]),
                                      torch.tensor([pos]))
        toks.append(int(model.next_token(params, h)[0][0]))
    return toks


def test_greedy_engine_matches_jax_engine(served):
    jax_lm, jmodel, jparams, model, params = served
    base = _run(_engine(model, params, num_slots=2), PROMPTS)
    eos = int(base[1].tokens[2])                      # appears mid-stream
    outs = _run(_engine(model, params, num_slots=2, eos_id=eos), PROMPTS)
    js = jax_lm.serving
    jeng = js.ServingEngine(jmodel, jparams, js.ServeConfig(
        max_len=32, num_slots=2, max_new_tokens=6, eos_id=eos))
    for p in PROMPTS:
        jeng.submit(js.Request(prompt=p))
    jouts = jeng.run()
    assert [r.tokens for r in outs] == [tuple(int(t) for t in r.tokens)
                                        for r in jouts]
    assert [r.finish_reason for r in outs] == [r.finish_reason for r in jouts]
    assert "eos" in [r.finish_reason for r in outs]
    for p, r in zip(PROMPTS, base):
        assert list(r.tokens) == _reference_decode(model, params, p, 6), p


def test_lockstep_engine_matches_jax_lockstep_engine(served):
    """The lockstep baseline admits only into an empty pool and holds
    finished rows until the chunk drains: its tokens and latencies equal
    the JAX lockstep engine's, its tokens equal the continuous engine's,
    and the ragged mix takes it more ticks."""
    jax_lm, jmodel, jparams, model, params = served
    reqs = [([1, 2, 3], 6), ([4, 5], 2), ([6, 7, 8, 9], 6), ([10], 2),
            ([11, 12], 4)]

    def run(scheduler):
        eng = _engine(model, params, num_slots=2, scheduler=scheduler)
        for p, mn in reqs:
            eng.submit(Request(prompt=p, max_new_tokens=mn))
        return eng.run(), eng

    outs, eng = run("lockstep")
    js = jax_lm.serving
    jeng = js.ServingEngine(jmodel, jparams, js.ServeConfig(
        max_len=32, num_slots=2, max_new_tokens=6, scheduler="lockstep"))
    for p, mn in reqs:
        jeng.submit(js.Request(prompt=p, max_new_tokens=mn))
    jouts = jeng.run()
    assert [r.tokens for r in outs] == [tuple(int(t) for t in r.tokens)
                                        for r in jouts]
    assert [r.latency_steps for r in outs] == [r.latency_steps for r in jouts]
    assert eng.metrics.decode_steps == jeng.metrics.decode_steps
    cont, ceng = run("continuous")
    assert [r.tokens for r in outs] == [r.tokens for r in cont]
    assert eng._tick > ceng._tick


def test_slot_reuse_ragged_workload(served):
    *_, model, params = served
    reqs = [([1, 2, 3], 6), ([4, 5], 2), ([6, 7, 8, 9], 6), ([10], 2),
            ([11, 12], 4)]
    eng = _engine(model, params, num_slots=2)
    ids = [eng.submit(Request(prompt=p, max_new_tokens=mn)) for p, mn in reqs]
    outs = eng.run()
    assert [r.request_id for r in outs] == ids
    assert all(isinstance(r, GenerationResult) for r in outs)
    assert [len(r.tokens) for r in outs] == [mn for _, mn in reqs]
    m = eng.metrics
    assert m.prefills == 5 and m.completed == 5 and m.tokens_generated == 20
    assert m.peak_live_slots == 2 and eng.queue_depth == 0
    lat = {r.request_id: r.latency_steps for r in outs}
    assert lat[1] < lat[2]                # the short request left early
    for (p, mn), r in zip(reqs, outs):
        assert list(r.tokens) == _reference_decode(model, params, p, mn)


def test_max_new_tokens_one_and_on_token(served):
    *_, model, params = served
    eng = _engine(model, params, num_slots=1)
    outs = _run(eng, [[1, 2], [3, 4]], max_new_tokens=1)
    assert [len(r.tokens) for r in outs] == [1, 1]
    assert eng.metrics.decode_steps == 0          # never occupied a slot
    seen = []
    out = _run(_engine(model, params), [[1, 2, 3]], on_token=seen.append)[0]
    assert tuple(seen) == out.tokens and len(seen) == 6


def test_submit_and_config_validation(served):
    *_, model, params = served
    eng = _engine(model, params)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(Request(prompt=[]))
    with pytest.raises(ValueError, match="temperature"):
        eng.submit(Request(prompt=[1], sampling=SamplingParams(temperature=0.0)))
    with pytest.raises(ValueError, match="top_k"):
        eng.submit(Request(prompt=[1], sampling=SamplingParams(top_k=0)))
    with pytest.raises(ValueError, match="estimator"):
        eng.submit(Request(prompt=[1], sampling=SamplingParams(estimator="mean")))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(prompt=[1] * 30, max_new_tokens=10))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(prompt=[1], max_new_tokens=0))
    for bad, err in ((dict(top_k=0), "top_k"), (dict(num_slots=0), "num_slots"),
                     (dict(scheduler="chunked"), "scheduler"),
                     (dict(temperature=0.0), "temperature"),
                     (dict(num_pages=4), "page_size"),
                     (dict(candidate_mode=(1, 2, 3)), "candidate_mode")):
        with pytest.raises(ValueError, match=err):
            ServingEngine(model, params, ServeConfig(**bad))
    with pytest.raises(ValueError, match="lockstep"):
        ServingEngine(model, params, ServeConfig(scheduler="lockstep",
                                                 page_size=16))
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("xlstm-350m")


def test_sampling_determinism_and_fresh_streams(served):
    *_, model, params = served

    def run_once():
        eng = _engine(model, params, num_slots=4, max_new_tokens=5,
                      temperature=0.9, top_k=8, seed=42)
        for i, p in enumerate(PROMPTS[:4]):
            eng.submit(Request(prompt=p, sampling=SamplingParams(
                temperature=0.5 + 0.2 * i, top_k=2 + i)))
        return [r.tokens for r in eng.run()]

    outs = run_once()
    assert outs == run_once()
    assert all(len(s) == 5 and all(0 <= t < 256 for t in s) for s in outs)
    eng = _engine(model, params, num_slots=1, temperature=1.5, top_k=8)
    seqs = [_run(eng, [[1, 2, 3]])[0].tokens for _ in range(3)]
    assert len(set(seqs)) > 1                     # a fresh stream per request


def test_sampling_is_slot_and_neighbour_independent(served):
    *_, model, params = served

    def run_a(order):
        eng = _engine(model, params, seed=7)
        rid = None
        for name in order:
            if name == "A":
                rid = eng.submit(Request(prompt=[3, 7], sampling=SamplingParams(
                    temperature=1.3, top_k=8, seed=99)))
            else:
                eng.submit(Request(prompt=[9, 1, 4], sampling=SamplingParams(
                    temperature=1.1, top_k=5)))
        return {r.request_id: r.tokens for r in eng.run()}[rid]

    assert run_a("ABC") == run_a("BCA") == run_a("A")


def test_explicit_seed_does_not_collide_with_request_id_streams(served):
    *_, model, params = served
    knobs = dict(temperature=1.4, top_k=8)
    eng = _engine(model, params, num_slots=1, seed=3)
    _run(eng, [[5], [5]])                                  # request ids 0, 1
    unseeded = _run(eng, [[3, 7]], sampling=SamplingParams(**knobs))[0]
    assert unseeded.request_id == 2
    seeded = _run(_engine(model, params, num_slots=1, seed=3), [[3, 7]],
                  sampling=SamplingParams(seed=2, **knobs))[0]
    assert seeded.tokens != unseeded.tokens


def test_greedy_rows_are_inert(served):
    *_, model, params = served
    want = _reference_decode(model, params, [3, 1, 4], 4)
    eng = _engine(model, params, max_new_tokens=4, seed=7)
    rid = eng.submit(Request(prompt=[3, 1, 4]))
    eng.submit(Request(prompt=[2, 7], sampling=SamplingParams(
        temperature=1.2, top_k=6)))
    eng.submit(Request(prompt=[5, 5], sampling=SamplingParams(
        estimator="median")))
    outs = {r.request_id: r.tokens for r in eng.run()}
    assert list(outs[rid]) == want


def test_exact_candidate_mode_equals_streaming(served):
    """candidate_mode=(B, R) keeps every class a candidate: greedy and
    sampled tokens equal the streaming engine's (through kernels 7-8's
    plain versions, which must run)."""
    *_, model, params = served
    mach = model.cfg.mach
    sampling = [SamplingParams(), SamplingParams(temperature=1.2, top_k=6),
                SamplingParams(estimator="min")]

    def run(mode):
        eng = _engine(model, params, num_slots=2, candidate_mode=mode)
        for p, sp in zip(PROMPTS, sampling * 2):
            eng.submit(Request(prompt=p, sampling=sp))
        return [r.tokens for r in eng.run()]

    calls = []
    plain = mc.mach_candidate_topk_plain

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    mc.mach_candidate_topk_plain = counted
    try:
        cand = run((mach.num_buckets, mach.num_repetitions))
    finally:
        mc.mach_candidate_topk_plain = plain
    assert calls
    assert cand == run(None)

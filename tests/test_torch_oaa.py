"""The one-vs-all (OAA) baseline in the port against the JAX package, on
the CPU: ``OAAClassifier``, and the LM's dense softmax head
(``cfg.mach is None``) on the smoke recurrentgemma-2b, tied to the
embeddings and untied with a logit soft cap, through loss, gradients,
greedy decode, top-k and the serving engine; and the quickstart.

Same numpy inputs and converted params on both sides.  Tolerances:
``OAAClassifier`` logits, probabilities, loss and gradients at rtol 1e-5
(atol 1e-6 for gradient entries near zero), predictions exactly; the LM
at test_torch_lm_loss.py's float32 rules (loss rtol 1e-5, each gradient
leaf within 1e-5 of its largest entry); greedy tokens, top-k ids and the
engine's greedy tokens exactly, top-k values at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oaa as joaa
from repro_torch import convert
from repro_torch.core import OAAClassifier
from repro_torch.examples import quickstart
from repro_torch.optim import value_and_grad
from repro_torch.serving import Request, SamplingParams, ServeConfig, \
    ServingEngine
from torch_lm_cases import (LOWERED, RTOL, T, batch, jax_loss_and_grads,
                            leaves, pair)
from torch_reference import jax_lm  # noqa: F401  (fixture)

PROMPTS = [[1, 2, 3], [4, 5, 6], [7, 8], [9, 10, 11]]


def test_classifier_matches_jax():
    k, d, n = 300, 24, 17
    jclf, tclf = joaa.OAAClassifier(k, d), OAAClassifier(k, d)
    jp = jclf.init(jax.random.key(0))
    jp["b"] = jax.random.normal(jax.random.key(1), (k,)) * 0.1
    tp = convert.convert_params(tclf, jax.tree.map(np.asarray, jp),
                                device="cpu")
    assert tclf.param_count() == jclf.param_count() == d * k + k
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, k, size=n).astype(np.int32)
    weights = (rng.uniform(size=n) > 0.3).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(tclf.logits(tp, tx).numpy(),
                               np.asarray(jclf.logits(jp, jnp.asarray(x))),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        tclf.class_probs(tp, tx).numpy(),
        np.asarray(jclf.class_probs(jp, jnp.asarray(x))), rtol=RTOL,
        atol=1e-7)
    np.testing.assert_array_equal(tclf.predict(tp, tx).numpy(),
                                  np.asarray(jclf.predict(jp, jnp.asarray(x))))
    for w in (None, weights):
        jl, jg = jax.value_and_grad(jclf.loss)(
            jp, jnp.asarray(x), jnp.asarray(y),
            None if w is None else jnp.asarray(w))
        tl, tg = value_and_grad(tclf.loss, tp, tx, ty,
                                None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
        for key in ("w", "b"):
            np.testing.assert_allclose(tg[key].numpy(), np.asarray(jg[key]),
                                       rtol=RTOL, atol=1e-6)
    with pytest.raises(ValueError, match="expected"):
        convert.convert_params(tclf, {"w": np.zeros((d, k + 1), np.float32),
                                      "b": np.zeros(k, np.float32)},
                               device="cpu")
    params = tclf.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["w"].shape == (d, k) and not params["b"].any()


# (tie_embeddings, logit_softcap)
HEADS = {"tied": {"tie_embeddings": True},
         "untied softcap": {"tie_embeddings": False, "logit_softcap": 30.0}}


@pytest.fixture(scope="module", params=sorted(HEADS))
def oaa_pair(request, jax_lm):
    return pair(jax_lm, "float32", mach=None, **HEADS[request.param],
                **LOWERED)


@pytest.mark.parametrize("weighted", [False, True])
def test_lm_loss_and_grads_match(oaa_pair, weighted):
    jmodel, jparams, model, params = oaa_pair
    assert model.head is None and "mach_head" not in params
    assert ("lm_head" in params) == (not model.cfg.tie_embeddings)
    jbatch, tbatch = batch(T, weighted, seed=7)
    jloss, jmet, jgrads = jax_loss_and_grads(jmodel, jparams, jbatch, model)
    (loss, metrics), grads = value_and_grad(model.loss, params, tbatch,
                                            has_aux=True)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    assert float(metrics["tokens"]) == float(jmet["tokens"])
    for got, want in zip(leaves(grads), leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))


def test_lm_greedy_and_topk_match(oaa_pair):
    jmodel, jparams, model, params = oaa_pair
    rng = np.random.default_rng(8)
    h = rng.normal(size=(5, model.cfg.d_model)).astype(np.float32)
    h[4] = h[3]                                     # a repeated row
    jidx, jval = jmodel.next_token(jparams, jnp.asarray(h))
    idx, val = model.next_token(params, torch.from_numpy(h))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=RTOL)
    jv, ji = jmodel.topk_scores(jparams, jnp.asarray(h), 10)
    tv, ti = model.topk_scores(params, torch.from_numpy(h), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    # candidates: the logits themselves, estimator and candidate_mode ignored
    cv, ci = model.topk_candidates(params, torch.from_numpy(h), 10,
                                   candidate_mode=(2, 1))
    assert torch.equal(cv, tv) and torch.equal(ci, ti)


def test_lm_engine_serves_oaa_greedy_and_refuses_an_estimator(jax_lm,
                                                              oaa_pair):
    jmodel, jparams, model, params = oaa_pair
    eng = ServingEngine(model, params, ServeConfig(
        max_len=32, num_slots=2, max_new_tokens=5,
        candidate_mode=(2, 1)))                  # ignored by the OAA head
    for p in PROMPTS:
        eng.submit(Request(prompt=p))
    outs = eng.run()
    js = jax_lm.serving
    jeng = js.ServingEngine(jmodel, jparams, js.ServeConfig(
        max_len=32, num_slots=2, max_new_tokens=5))
    for p in PROMPTS:
        jeng.submit(js.Request(prompt=p))
    jouts = jeng.run()
    assert [r.tokens for r in outs] == [tuple(int(t) for t in r.tokens)
                                        for r in jouts]
    with pytest.raises(ValueError, match="OAA"):
        eng.submit(Request(prompt=[1], sampling=SamplingParams(
            estimator="min")))
    # sampled requests run on the OAA head too
    eng.submit(Request(prompt=[3, 4], sampling=SamplingParams(
        temperature=0.8, top_k=5, seed=1)))
    (res,) = eng.run()
    assert len(res.tokens) == 5


def test_quickstart_runs_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[cpu]" in out and "OAA baseline" in out
    assert out.count("MACH B=") == len(quickstart.CONFIGS)

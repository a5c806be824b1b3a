"""The serving slice as a whole: JAX ``MACHLinear.init`` → numpy →
``convert`` → port, then Algorithm 2 through both packages on the same
dense and CSR batches (the CSR ones from the JAX generator, ragged).

Logits agree at rtol 1e-5 / atol 1e-6 (f32 matmuls in another order);
meta-probabilities likewise; predictions agree except on near-ties of
the estimator scores.  Also: the converter's checks, the entry points'
refusal to run on the CPU unless asked, and the port's own generators.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mach as jm
from repro.data import extreme as jd
from repro.kernels import ref as jref
from repro.kernels.mach_topk import mach_topk_pallas
from repro_torch import convert
from repro_torch.configs.odp_mach import IMAGENET, ODP
from repro_torch.core import estimators as te
from repro_torch.core import mach as tm
from repro_torch.data import extreme as td
from repro_torch.kernels import ops
from torch_cases import assert_topk_close

ESTIMATORS = ("unbiased", "min", "median")
DIM = 96


def _models(estimator="unbiased", hash_kind="auto"):
    jcfg = jm.MACHConfig(600, 16, 5, estimator=estimator, hash_kind=hash_kind)
    tcfg = tm.MACHConfig(600, 16, 5, estimator=estimator, hash_kind=hash_kind)
    jhead, thead = jm.MACHLinear(jcfg, DIM), tm.MACHLinear(tcfg, DIM)
    jparams = jhead.init(jax.random.key(3))
    jparams["b"] = jax.random.normal(jax.random.key(4), jparams["b"].shape) * 0.1
    tparams = convert.convert_params(thead, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jhead, jparams, thead, tparams


@functools.lru_cache(maxsize=None)
def _csr_batch():
    """One ragged JAX-generated CSR batch per process (read-only)."""
    cfg = jd.SparseExtremeDataConfig(num_classes=600, num_features=DIM, nnz=12,
                                     sig_features=4, length_zipf_a=1.0, seed=1)
    jb, _ = jd.SparseExtremeDataset(cfg).batch_at(0, 10)
    tb = td.SparseBatch(torch.from_numpy(np.array(jb.indptr)),
                        torch.from_numpy(np.array(jb.indices)),
                        torch.from_numpy(np.array(jb.values)),
                        jb.num_features, jb.nnz_max)
    assert len(set(np.diff(np.asarray(jb.indptr)).tolist())) > 1   # ragged
    return jb, tb


def _dense_batch():
    x = np.random.default_rng(0).normal(size=(13, DIM)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_logits_and_meta_probs_match(kind):
    jhead, jp, thead, tp = _models()
    jx, tx = _dense_batch() if kind == "dense" else _csr_batch()
    np.testing.assert_allclose(thead.head_logits(tp, tx).numpy(),
                               np.asarray(jhead.head_logits(jp, jx)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(thead.meta_probs(tp, tx).numpy(),
                               np.asarray(jhead.meta_probs(jp, jx)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("estimator", ESTIMATORS)
@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_predict_and_predict_topk_match(kind, estimator):
    jhead, jp, thead, tp = _models(estimator)
    jx, tx = _dense_batch() if kind == "dense" else _csr_batch()
    table = np.asarray(jhead.cfg.table())
    scores = np.asarray(jhead.class_probs(jp, jx))              # (n, K)
    np.testing.assert_allclose(thead.class_probs(tp, tx).numpy(), scores,
                               rtol=1e-5, atol=1e-6)
    want = np.asarray(jhead.predict(jp, jx))
    got = thead.predict(tp, tx).numpy()
    assert_topk_close(scores[np.arange(len(got)), got][:, None], got[:, None],
                      scores[np.arange(len(want)), want][:, None],
                      want[:, None], scores, rtol=1e-5)
    # top-k: the JAX TPU kernel (interpret) on the JAX meta-probs
    jmeta = jnp.moveaxis(jhead.meta_probs(jp, jx), 0, -2)
    jv, ji = mach_topk_pallas(jmeta, jnp.asarray(table), num_classes=600, k=5,
                              estimator=estimator, interpret=True)
    tv, ti = te.predict_topk(thead.meta_probs(tp, tx),
                             thead.table("cpu"), 5, estimator)
    assert_topk_close(tv.numpy(), ti.numpy(), jv, ji, scores, rtol=1e-5)


def test_top1_matches_predict_and_topk():
    """Greedy decode: mach_top1 (sum) = predict_topk(k=1) = predict."""
    _, _, thead, tp = _models(hash_kind="mult_shift")
    _, tx = _csr_batch()
    meta = thead.meta_probs(tp, tx)
    fam = thead.cfg.family
    _, i1 = ops.mach_top1(meta.movedim(0, -2), num_classes=600,
                          inline_coeffs=fam.coeffs_tensor("cpu"),
                          inline_shift=fam.shift)
    _, ik = te.predict_topk(meta, thead.table("cpu"), 1, "unbiased")
    np.testing.assert_array_equal(i1.numpy(), ik[:, 0].numpy())
    np.testing.assert_array_equal(i1.numpy(), thead.predict(tp, tx).numpy())


def test_output_head_matches():
    jcfg, tcfg = jm.MACHConfig(500, 8, 4), tm.MACHConfig(500, 8, 4)
    jhead, thead = jm.MACHOutputHead(jcfg, 24), tm.MACHOutputHead(tcfg, 24)
    jp = jhead.init(jax.random.key(0))
    tp = convert.convert_params(thead, {"kernel": np.asarray(jp["kernel"])},
                                device="cpu")
    h = np.random.default_rng(2).normal(size=(2, 3, 24)).astype(np.float32)
    np.testing.assert_allclose(thead.apply(tp, torch.from_numpy(h)).numpy(),
                               np.asarray(jhead.apply(jp, jnp.asarray(h))),
                               rtol=1e-5, atol=1e-6)
    assert thead.param_count() == jhead.param_count()
    assert thead.full_softmax_param_count() == jhead.full_softmax_param_count()


def test_converter_rejects_bad_params():
    _, jp, thead, _ = _models()
    good = {k: np.asarray(v) for k, v in jp.items()}
    with pytest.raises(ValueError, match="shape"):
        convert.convert_params(thead, {**good, "w": good["w"][:, :, :8]},
                               device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.convert_params(thead, {**good, "b": good["b"].T}, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        convert.convert_params(thead, {**good, "b": good["b"].astype(np.float64)},
                               device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.convert_params(thead, {"w": good["w"]}, device="cpu")
    out = convert.convert_params(thead, good, device="cpu")
    assert out["w"].dtype == torch.float32 and tuple(out["w"].shape) == (DIM, 5, 16)


def test_slice_merge_and_param_count():
    jhead, jp, thead, tp = _models()
    assert thead.param_count() == jhead.param_count()
    parts = [tm.MACHLinear.slice_repetition(tp, j) for j in range(5)]
    merged = tm.MACHLinear.merge_repetitions(parts)
    assert torch.equal(merged["w"], tp["w"]) and torch.equal(merged["b"], tp["b"])


def test_entry_points_refuse_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    head = tm.MACHLinear(ODP.mach(small=True), 16)
    gen = torch.Generator().manual_seed(0)
    dcfg = ODP.sparse_data(small=True)
    for call in (lambda: head.init(gen),
                 lambda: head.cfg.table(),
                 lambda: td.SparseExtremeDataset(dcfg),
                 lambda: convert.convert_params(head, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = head.init(gen, device="cpu")
    assert params["w"].device.type == "cpu"
    assert td.SparseExtremeDataset(dcfg, device="cpu").signatures.device.type == "cpu"


def test_init_is_seeded_and_scaled():
    head = tm.MACHLinear(tm.MACHConfig(100, 8, 3), 400)
    p1 = head.init(torch.Generator().manual_seed(5), device="cpu")
    p2 = head.init(torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(p1["w"], p2["w"]) and not p1["b"].any()
    assert abs(float(p1["w"].std()) * 20.0 - 1.0) < 0.05      # 1/sqrt(d)


def test_densify_sums_duplicates_like_jax():
    indptr = np.array([0, 3, 3, 6], np.int32)
    indices = np.array([1, 1, 4, 0, 2, 2], np.int32)
    values = np.array([0.5, 0.25, 1.0, 2.0, 1.5, -0.5], np.float32)
    want = np.asarray(jref.csr_densify_ref(jnp.asarray(indptr),
                                           jnp.asarray(indices),
                                           jnp.asarray(values), 6))
    got = td.SparseBatch(torch.from_numpy(indptr), torch.from_numpy(indices),
                         torch.from_numpy(values), 6, 3).to_dense()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ragged", [0.0, 1.0])
def test_sparse_generator_matches_jax_statistically(ragged):
    """Same shapes, ranges and row invariants as the JAX generator; pure
    in (seed, step)."""
    cfg = ODP.sparse_data(small=True)
    cfg = td.SparseExtremeDataConfig(**{**cfg.__dict__, "length_zipf_a": ragged})
    ds = td.SparseExtremeDataset(cfg, device="cpu")
    batch, y = ds.batch_at(3, 64)
    again, y2 = ds.batch_at(3, 64)
    assert torch.equal(batch.indices, again.indices) and torch.equal(y, y2)
    assert not torch.equal(ds.batch_at(4, 64)[1], y)
    lengths = torch.diff(batch.indptr.long())
    assert batch.indptr.dtype == batch.indices.dtype == y.dtype == torch.int32
    assert int(lengths.min()) >= cfg.sig_features
    assert int(lengths.max()) <= cfg.nnz
    assert (lengths < cfg.nnz).any() == (ragged > 0)
    assert 0 <= int(batch.indices.min()) and int(batch.indices.max()) < cfg.num_features
    # each row's values are L2-normalized before densification (duplicate
    # ids then sum, as in the JAX generator)
    rows = torch.repeat_interleave(torch.arange(64), lengths)
    sq = torch.zeros(64).index_add_(0, rows, batch.values ** 2)
    np.testing.assert_allclose(sq.numpy(), 1.0, rtol=1e-5)
    # signature features of the label are present in each row
    for row in range(4):
        cols = set(batch.indices[batch.indptr[row]:batch.indptr[row + 1]].tolist())
        assert set(ds.signatures[y[row]].tolist()) <= cols
    # Zipf labels: class 0 is the most frequent, as in the JAX generator
    big = ds.batch_at(0, 4096)[1]
    assert int(torch.bincount(big.long()).argmax()) == 0


def test_dense_generator_and_configs():
    ds = td.ExtremeDataset(td.ExtremeDataConfig(50, 16, noise=0.1), device="cpu")
    x, y = ds.batch_at(0, 32)
    assert tuple(x.shape) == (32, 16) and y.dtype == torch.int32
    assert ds.bayes_accuracy(steps=2, batch_size=64) > 0.9
    assert IMAGENET.mach().num_buckets == 512
    assert ODP.mach() == tm.MACHConfig(105033, 32, 25, hash_kind="mult_shift")
    with pytest.raises(ValueError):
        IMAGENET.sparse_data()

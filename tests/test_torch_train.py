"""The training slice as a whole: JAX ``MACHLinear.init`` → numpy →
``convert`` → port, then 5 AdamW steps through both packages on the
same batches.  The port trains through the fused logit-free loss
(``MACHLinear(fused=True)``, CPU plain path); the JAX package through its
materializing loss (``fused=False``, documented as equal in value and
gradients) with ``repro.optim.adamw`` and ``apply_updates``.

Losses agree at rtol 1e-5; the final params at rtol 1e-4 / atol 1e-6
(five Adam steps amplify f32 summation-order differences: the update
divides each moment by the square root of another).  Also:
``MACHOutputHead.fused_loss`` equals ``loss`` with its gradients, and
the port's training example runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jo
from repro.core import mach as jm
from repro.data import extreme as jd
from repro_torch import convert
from repro_torch import optim as to
from repro_torch.configs.odp_mach import IMAGENET, ODP
from repro_torch.core import mach as tm
from repro_torch.data import extreme as td
from repro_torch.examples import extreme_classification as example

STEPS, N, LR = 5, 32, 0.05


def _heads(task):
    c = task.mach(small=True)
    jcfg = jm.MACHConfig(c.num_classes, c.num_buckets, c.num_repetitions,
                         hash_kind=c.hash_kind)
    jhead = jm.MACHLinear(jcfg, task.small_dim)
    thead = tm.MACHLinear(c, task.small_dim, fused=True)
    jp = jhead.init(jax.random.key(0))
    jp["b"] = jax.random.normal(jax.random.key(1), jp["b"].shape) * 0.1
    tp = convert.convert_params(thead, jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jhead, jp, thead, tp


def _csr_batches():
    """Ragged ODP-small CSR batches from the JAX generator (K=1024,
    d=256, nnz<=32), as (jax batch, port batch, labels)."""
    cfg = jd.SparseExtremeDataConfig(
        num_classes=ODP.small_classes, num_features=ODP.small_dim,
        nnz=ODP.small_nnz, sig_features=ODP.small_nnz // 2,
        length_zipf_a=1.0, seed=0)
    ds = jd.SparseExtremeDataset(cfg)
    out = []
    for step in range(STEPS):
        jb, y = ds.batch_at(step, N)
        tb = td.SparseBatch(*(torch.from_numpy(np.array(a))
                              for a in (jb.indptr, jb.indices, jb.values)),
                            jb.num_features, jb.nnz_max)
        out.append((jb, tb, np.array(y)))
    return out


def _dense_batches(dim, num_classes):
    """Nonnegative unit-norm features, as ImageNet-21k's CNN embeddings
    (post-ReLU) are.  With mixed signs, weight-gradient entries that
    cancel to near zero carry f32 order noise that Adam's normalization
    lifts to ~1e-4 relative in about 0.02% of the params."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        x = np.abs(rng.normal(size=(N, dim))).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        y = rng.integers(0, num_classes, size=N).astype(np.int32)
        out.append((jnp.asarray(x), torch.from_numpy(x), y))
    return out


def _train_both(jhead, jp, thead, tp, batches):
    jopt, topt = jo.adamw(LR), to.adamw(LR)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jgrad = jax.jit(jax.value_and_grad(jhead.loss))
    for jx, tx, y in batches:
        jl, jg = jgrad(jp, jx, jnp.asarray(y))
        tl, tg = to.value_and_grad(thead.loss, tp, tx, torch.from_numpy(y))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        jupd, jstate = jopt.update(jg, jstate, jp)
        jp = jo.apply_updates(jp, jupd)
        tupd, tstate = topt.update(tg, tstate, tp)
        tp = to.apply_updates(tp, tupd)
    for key in ("w", "b"):
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                   rtol=1e-4, atol=1e-6)
    return float(tl)


def test_converted_params_carry_across():
    jhead, jp, thead, tp = _heads(ODP)
    assert thead.fused and thead.param_count() == jhead.param_count()
    for key in ("w", "b"):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))


def test_odp_small_csr_training_matches_jax():
    jhead, jp, thead, tp = _heads(ODP)
    batches = _csr_batches()
    assert len({int(n) for n in np.diff(np.asarray(batches[0][0].indptr))}) > 1
    last = _train_both(jhead, jp, thead, tp, batches)
    assert np.isfinite(last)


def test_imagenet_small_dense_training_matches_jax():
    jhead, jp, thead, tp = _heads(IMAGENET)
    _train_both(jhead, jp, thead, tp,
                _dense_batches(IMAGENET.small_dim, IMAGENET.small_classes))


def test_output_head_fused_loss_equals_loss_with_grads():
    jcfg, tcfg = jm.MACHConfig(500, 16, 4), tm.MACHConfig(500, 16, 4)
    jhead, thead = jm.MACHOutputHead(jcfg, 24), tm.MACHOutputHead(tcfg, 24)
    jp = jhead.init(jax.random.key(2))
    tp = convert.convert_params(thead, {"kernel": np.asarray(jp["kernel"])},
                                device="cpu")
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 5, 24)).astype(np.float32)
    y = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    weights = (rng.uniform(size=(2, 5)) > 0.3).astype(np.float32)
    jloss = lambda p, h_: jhead.loss(p, h_, jnp.asarray(y), jnp.asarray(weights))
    jl, (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    tk = tp["kernel"].requires_grad_(True)
    tl = thead.fused_loss({"kernel": tk}, th, torch.from_numpy(y),
                          torch.from_numpy(weights))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(
        float(thead.loss({"kernel": tk}, th, torch.from_numpy(y),
                         torch.from_numpy(weights))), float(jl), rtol=1e-5)
    gk, gh = torch.autograd.grad(tl, [tk, th])
    np.testing.assert_allclose(gk.numpy(), np.asarray(jgp["kernel"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-6)


def test_fused_loss_rejects_bucket_select():
    """bucket_select is ported: the head rejects a c_sel below 1 (as the
    JAX package does) and returns a loss for a valid one."""
    _, _, thead, tp = _heads(ODP)
    x, y = torch.zeros(2, ODP.small_dim), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="c_sel"):
        thead.fused_loss(tp, x, y, bucket_select=(0, 1))
    assert torch.isfinite(thead.fused_loss(tp, x, y, bucket_select=(8, 1)))


def test_training_example_runs_on_cpu(capsys):
    assert example.main(["--device", "cpu", "--steps", "3", "--task", "odp"]) == 0
    out = capsys.readouterr().out
    assert "fused CSR path" in out and "|Δ| = " in out and "[cpu]" in out

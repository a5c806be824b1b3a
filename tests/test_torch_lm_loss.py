"""``LanguageModel.loss`` and its gradients against the JAX package's
``jax.value_and_grad(model.loss)``, at the smoke size on the CPU.

The JAX package's recurrentgemma-2b smoke model is built inside
``jax_reference()``; its params reach the port through
``convert.convert_lm_params`` (gradients too, leaf for leaf), and the
token batches are the same numpy arrays.  The port differentiates with
autograd through the backward kernels' plain versions (kernel 3, the
RG-LRU reverse loop, the flash backward); the thresholds are lowered so
that the 24-token sequences take the flash branch on both sides.

Tolerances.  Float32: the loss at rtol 1e-5, every gradient leaf at rtol
1e-5 of its largest entry (the JAX RG-LRU runs an associative scan and
the port a sequential loop; sums run in other orders), with and without
weights, with ``remat="full"`` on both sides in one case.  bfloat16
params and activations (the full config's types, embedding scale
√2560): each gradient leaf within ``bf16_tol`` of its largest entry,
test_torch_lm's rule (one bf16 ulp per residual sub-block and layer),
and each held to the gradient of the same model in float32 (the bf16
params cast) with at most twice the relative L2 error of JAX's bf16
gradient, plus 2^-9 (PR 14's rule); the loss likewise.  The T = 2048
case, where both take their default flash branch, is in
test_torch_lm_train.py.

The fused logit-free loss (``mach_fused_loss=True``; kernel 4's plain
version here, JAX's ``ref.mach_fused_xent_ref``) is held the same way in
float32 and bfloat16, and to the port's unfused loss in float32; a float32
head under bf16 activations keeps its float32 gradient (both operands are
read in float32, as the JAX op reads them); and with
``mach_bucket_select=(8, 1)`` on a batch whose labels hit at most six
buckets a repetition, at the float32 rules, with exactly the unselected
head columns' gradients zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models.model import LanguageModel
from repro_torch.optim import value_and_grad
from torch_lm_cases import (LOWERED, RTOL, T, batch, jax_loss_and_grads,
                            leaves, pair)
from torch_reference import jax_lm  # noqa: F401  (fixture)


def _rel_l2(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("weighted,remat", [(False, "full"), (True, "none")])
def test_loss_and_grads_match_float32(jax_lm, weighted, remat):
    jmodel, jparams, model, params = pair(jax_lm, "float32", remat=remat,
                                          **LOWERED)
    jbatch, tbatch = batch(T, weighted)
    jloss, jmet, jgrads = jax_loss_and_grads(jmodel, jparams, jbatch, model)
    (loss, metrics), grads = value_and_grad(model.loss, params, tbatch,
                                            has_aux=True)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=RTOL)
    assert float(metrics["tokens"]) == float(jmet["tokens"])
    for got, want in zip(leaves(grads), leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_and_grads_match_bfloat16(jax_lm, weighted):
    jmodel, jparams, model, params = pair(jax_lm, "bfloat16", **LOWERED)
    jbatch, tbatch = batch(T, weighted, seed=2)
    jloss, _, jgrads = jax_loss_and_grads(jmodel, jparams, jbatch, model)
    (loss, _), grads = value_and_grad(model.loss, params, tbatch,
                                      has_aux=True)
    # the same model in float32 on the bf16 params, as the truth
    jm32 = jax_lm.models.LanguageModel(dataclasses.replace(
        jmodel.cfg, dtype=jnp.float32, param_dtype=None))
    m32 = LanguageModel(dataclasses.replace(model.cfg, dtype=torch.float32,
                                            param_dtype=None))
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x,
                        jparams)
    tloss, _, truth = jax_loss_and_grads(jm32, jp32, jbatch, m32)
    tol = 2 * model.cfg.num_layers * 2.0 ** -8          # test_torch_lm's
    assert abs(float(loss) - tloss) <= 2 * abs(jloss - tloss) + \
        2.0 ** -9 * abs(tloss)
    np.testing.assert_allclose(float(loss), jloss, rtol=tol)
    for got, want, true in zip(leaves(grads), leaves(jgrads),
                               leaves(truth)):
        assert got.dtype == torch.bfloat16 and want.dtype == torch.bfloat16
        assert float((got.float() - want.float()).abs().max()) <= \
            tol * float(want.float().abs().max())
        assert _rel_l2(got, true) <= 2 * _rel_l2(want, true) + 2.0 ** -9


# ---------------------------------------------------------------------------
# the fused logit-free loss (mach_fused_loss=True: kernel 4's plain version
# here) and dynamic bucket selection (mach_bucket_select)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_fused_loss_and_grads_match_float32(jax_lm, weighted):
    """mach_fused_loss=True on both sides, at the float32 tolerances; the
    port's fused and unfused losses agree too."""
    jmodel, jparams, model, params = pair(jax_lm, "float32",
                                          mach_fused_loss=True, **LOWERED)
    jbatch, tbatch = batch(T, weighted, seed=3)
    jloss, _, jgrads = jax_loss_and_grads(jmodel, jparams, jbatch, model)
    (loss, _), grads = value_and_grad(model.loss, params, tbatch,
                                      has_aux=True)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    for got, want in zip(leaves(grads), leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))
    unfused = LanguageModel(dataclasses.replace(model.cfg,
                                                mach_fused_loss=False))
    (uloss, _), ugrads = value_and_grad(unfused.loss, params, tbatch,
                                        has_aux=True)
    np.testing.assert_allclose(float(loss), float(uloss), rtol=RTOL)
    for got, want in zip(leaves(grads), leaves(ugrads)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))


def test_fused_loss_and_grads_match_bfloat16(jax_lm):
    """bf16 params and activations through the fused loss, under
    test_loss_and_grads_match_bfloat16's rules."""
    jmodel, jparams, model, params = pair(jax_lm, "bfloat16",
                                          mach_fused_loss=True, **LOWERED)
    jbatch, tbatch = batch(T, True, seed=4)
    jloss, _, jgrads = jax_loss_and_grads(jmodel, jparams, jbatch, model)
    (loss, _), grads = value_and_grad(model.loss, params, tbatch,
                                      has_aux=True)
    jm32 = jax_lm.models.LanguageModel(dataclasses.replace(
        jmodel.cfg, dtype=jnp.float32, param_dtype=None))
    m32 = LanguageModel(dataclasses.replace(model.cfg, dtype=torch.float32,
                                            param_dtype=None))
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x,
                        jparams)
    tloss, _, truth = jax_loss_and_grads(jm32, jp32, jbatch, m32)
    tol = 2 * model.cfg.num_layers * 2.0 ** -8
    assert abs(float(loss) - tloss) <= 2 * abs(jloss - tloss) + \
        2.0 ** -9 * abs(tloss)
    np.testing.assert_allclose(float(loss), jloss, rtol=tol)
    for got, want, true in zip(leaves(grads), leaves(jgrads),
                               leaves(truth)):
        assert got.dtype == torch.bfloat16 and want.dtype == torch.bfloat16
        assert float((got.float() - want.float()).abs().max()) <= \
            tol * float(want.float().abs().max())
        assert _rel_l2(got, true) <= 2 * _rel_l2(want, true) + 2.0 ** -9


def test_fused_loss_float32_head_under_bfloat16_activations(jax_lm,
                                                           monkeypatch):
    """A float32 head kernel under bf16 activations: the JAX fused op reads
    both in float32, so the port promotes h (exactly) rather than rounding
    the kernel: the op gets the kernel's own bits; the loss matches JAX's
    at the bf16 tolerance and the head gradient stays float32."""
    jmodel, jparams, model, params = pair(jax_lm, "float32",
                                          mach_fused_loss=True, **LOWERED)
    jmodel = jax_lm.models.LanguageModel(dataclasses.replace(
        jmodel.cfg, dtype=jnp.bfloat16))
    model = LanguageModel(dataclasses.replace(model.cfg, dtype=torch.bfloat16))
    jbatch, tbatch = batch(T, False, seed=5)
    jloss, _, jgrads = jax_loss_and_grads(jmodel, jparams, jbatch, model)
    seen = []
    real = ops.mach_fused_xent

    def spy(h, w, *args, **kw):
        seen.append((h.dtype, w.dtype, torch.equal(
            w, params["mach_head"]["kernel"])))
        return real(h, w, *args, **kw)
    monkeypatch.setattr(ops, "mach_fused_xent", spy)
    (loss, _), grads = value_and_grad(model.loss, params, tbatch,
                                      has_aux=True)
    assert seen == [(torch.float32, torch.float32, True)]
    tol = 2 * model.cfg.num_layers * 2.0 ** -8
    np.testing.assert_allclose(float(loss), jloss, rtol=tol)
    got, want = grads["mach_head"]["kernel"], jgrads["mach_head"]["kernel"]
    assert got.dtype == want.dtype == torch.float32
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_fused_loss_with_bucket_select_matches_float32(jax_lm):
    """mach_bucket_select=(8, 1) on a batch whose labels hit at most six
    buckets a repetition (tokens from six ids): c_sel = 8 is above the
    distinct label buckets and below B = 16, so the selection is exact
    on the positive terms and cuts the rest; the proxy is computed in
    the loss on both sides."""
    jmodel, jparams, model, params = pair(
        jax_lm, "float32", mach_fused_loss=True, mach_bucket_select=(8, 1),
        **LOWERED)
    rng = np.random.default_rng(6)
    ids = rng.choice(256, size=6, replace=False)
    tokens = ids[rng.integers(0, 6, size=(2, T + 1))].astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(tokens)}, \
        {"tokens": torch.from_numpy(tokens)}
    hashed = model.cfg.mach.hash_labels(tbatch["tokens"][:, 1:])
    assert max(len(set(row.reshape(-1).tolist())) for row in hashed) <= 6
    jloss, _, jgrads = jax_loss_and_grads(jmodel, jparams, jbatch, model)
    (loss, _), grads = value_and_grad(model.loss, params, tbatch,
                                      has_aux=True)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    for got, want in zip(leaves(grads), leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))
    head = grads["mach_head"]["kernel"].reshape(-1, 4, 16)
    assert int((head == 0).all(dim=0).sum()) == 4 * (16 - 8)
    full = LanguageModel(dataclasses.replace(model.cfg,
                                             mach_bucket_select=None))
    assert float(loss) <= float(full.loss(params, tbatch)[0]) + 1e-6

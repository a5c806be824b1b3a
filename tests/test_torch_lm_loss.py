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
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

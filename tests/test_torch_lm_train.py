"""The LM training slice against the JAX package, at the smoke size on
the CPU: the loss and gradients at T = 2048, three trainer steps, and
the training entry point.  (Loss and gradients at the short length, in
float32 and bfloat16, are in test_torch_lm_loss.py.)

The JAX package's recurrentgemma-2b smoke model is built inside
``jax_reference()``; its params reach the port through
``convert.convert_lm_params`` (gradients too), and the token batches are
the same numpy arrays.

At T = 2048 with the default thresholds both models take their flash
branch in the attention layer (the port's kernel 10 plain version and
its backward, JAX's ``_attend_flash``), under ``remat="full"``: loss at
rtol 1e-5, every gradient leaf at rtol 1e-5 of its largest entry.

Trainer steps (float32 params; AdamW, AdamW with master weights,
Adafactor): loss, ``grad_norm`` and ``lr`` of each step at rtol 1e-5,
and the params after three steps within 1e-5 of each leaf's largest
entry — for AdamW all but 0.01% of the entries, which lie within
2·Σ lr: Adam divides each first moment by the root of the second, so a
weight gradient that cancels to float32 noise takes an update of about
lr whose sign the noise picks (3 of 239,808 entries here).  Adafactor's
factored second moment has no such entries.  The master-weights path in
bf16 is held exactly in ``test_torch_optim.py`` (with bf16 params the
two packages' gradients differ by bf16 roundings, which Adam lifts the
same way).
"""

import jax
import numpy as np
import pytest

from repro.train import trainer as jtrainer
from repro.train.train_state import new_train_state as jax_new_train_state
from repro_torch.convert import convert_lm_params
from repro_torch.launch import train as launch_train
from repro_torch.optim import value_and_grad
from repro_torch.train import TrainConfig, make_train_step, new_train_state
from torch_lm_cases import (LOWERED, RTOL, T, batch, jax_loss_and_grads,
                            leaves, pair)
from torch_reference import jax_lm  # noqa: F401  (fixture)


def test_loss_and_grads_match_at_the_flash_length(jax_lm):
    """T = 2048 at the default thresholds: both models take the flash
    branch (and its backward) in the attention layer."""
    jmodel, jparams, model, params = pair(jax_lm, "float32", remat="full")
    assert model.cfg.flash_threshold == 2048
    jbatch, tbatch = batch(2048, weighted=False, seed=1)
    jloss, _, jgrads = jax_loss_and_grads(jmodel, jparams, jbatch, model)
    (loss, _), grads = value_and_grad(model.loss, params, tbatch,
                                      has_aux=True)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    for got, want in zip(leaves(grads), leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))


OPTIMIZERS = {
    "adamw": dict(optimizer="adamw"),
    "adamw_master_weights": dict(optimizer="adamw", master_weights=True),
    "adafactor": dict(optimizer="adafactor", peak_lr=1e-2),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_trainer_steps_match(jax_lm, name):
    jmodel, jparams, model, params = pair(jax_lm, "float32", **LOWERED)
    tc = dict(dict(peak_lr=1e-3, warmup_steps=2, total_steps=10),
              **OPTIMIZERS[name])
    jstep, jopt = jtrainer.make_train_step(jmodel.loss,
                                           jtrainer.TrainConfig(**tc))
    step, opt = make_train_step(model.loss, TrainConfig(**tc))
    jstate, state = jax_new_train_state(jparams, jopt), new_train_state(params,
                                                                        opt)
    jstep = jax.jit(jstep)
    lr_sum = 0.0
    for s in range(3):
        jbatch, tbatch = batch(T, weighted=False, seed=10 + s)
        jstate, jmet = jstep(jstate, jbatch)
        state, met = step(state, tbatch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=RTOL)
        lr_sum += float(met["lr"])
    assert state.step == int(jstate.step) == 3
    want = convert_lm_params(model, jax.tree.map(np.asarray, jstate.params),
                             device="cpu")
    off = total = 0
    for got, w in zip(leaves(state.params), leaves(want)):
        err = (got - w).abs()
        assert float(err.max()) <= 2 * lr_sum
        off += int((err > RTOL * float(w.abs().max())).sum())
        total += err.numel()
    assert off <= (1e-4 * total if name.startswith("adamw") else 0), off


def test_launch_train_runs_on_the_cpu(capsys, tmp_path):
    assert launch_train.main(["--device", "cpu", "--steps", "2",
                              "--seq-len", "16", "--global-batch", "2",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and "finished at step 2 on cpu" in out

"""Shared pieces of the LM training parity tests: the smoke
recurrentgemma-2b of both packages on one set of params, numpy token
batches, and the JAX side's loss and gradients in the port's layout."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import convert_lm_params
from repro_torch.models.model import LanguageModel

RTOL = 1e-5
LOWERED = {"flash_threshold": 16, "chunk_q": 8, "chunk_k": 8}
T = 24


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def pair(jax_lm, dtype, **overrides):
    """(JAX model, JAX params, port model, port params) of the smoke
    config with ``overrides``, params in ``dtype``."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    bf16 = dtype == "bfloat16"
    kw = dict(overrides, dtype=jdt, param_dtype=jdt if bf16 else None)
    if bf16:
        kw["embed_scale"] = math.sqrt(2560.0)
    jcfg = dataclasses.replace(jax_lm.configs.get_config(
        "recurrentgemma-2b", smoke=True), **kw)
    jmodel = jax_lm.models.LanguageModel(jcfg)
    jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
    kw.update(dtype=tdt, param_dtype=tdt if bf16 else None)
    model = LanguageModel(dataclasses.replace(
        get_config("recurrentgemma-2b", smoke=True), **kw))
    params = convert_lm_params(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


def batch(t, weighted, seed=0):
    """(JAX batch, port batch) of the same 2 x (t + 1) tokens, with 0/1
    weights if ``weighted``."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, 256, (2, t + 1)).astype(np.int32)}
    if weighted:
        arrays["weights"] = (rng.uniform(size=(2, t)) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def jax_loss_and_grads(jmodel, jparams, jbatch, model):
    """JAX's (loss, metrics, gradients as the port's params of ``model``)."""
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, jbatch)
    grads = convert_lm_params(model, jax.tree.map(np.asarray, grads),
                              device="cpu")
    return float(loss), metrics, grads

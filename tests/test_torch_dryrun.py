"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
package's ``repro/launch/dryrun.py``: its helpers, a small LM's counted
flops against ``hlo_analysis.analyze`` of the same JAX function, and the
entry point on one full-width cell.  Each test that needs a world sets
up a fake one and tears it down inside itself (``dryrun.dry_step``), so
no other test in the process sees a default process group.  The fake
world against a real ``gloo`` one is in ``test_torch_multidevice.py``
(``test_dry_run_step_matches_a_real_world``: its rank side runs in the
spawned ``world4_split``).
"""

import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker

from repro.launch import hlo_analysis as ha
from repro.train import trainer as jtrainer
from repro.train.train_state import new_train_state as jax_new_train_state
from repro_torch.checkpoint import tree_flatten
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import PeakTracker, analyze
from repro_torch.models import LanguageModel
from repro_torch.train import TrainConfig, make_train_step, new_train_state
from torch_reference import jax_reference

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def jax_dryrun():
    """The JAX package's ``repro.launch.dryrun`` and configs; its import
    sets ``XLA_FLAGS`` (its first two lines), which is restored after."""
    before = os.environ.get("XLA_FLAGS")
    try:
        with jax_reference() as ns:
            yield importlib.import_module("repro.launch.dryrun"), ns.configs
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


class _JaxMesh:
    def __init__(self, shape: dict):
        self.shape = shape


class _TorchMesh:
    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self._sizes = tuple(shape.values())

    def size(self, i: int) -> int:
        return self._sizes[i]


MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_helpers_match_jax(arch):
    """``_active_params``, ``model_flops`` (the JAX ``lower_cell``'s
    6·N·D / 2·N·D), ``_train_cfg_for``'s microbatches and master weights,
    and the batch specs' shapes and dtypes, for every shape and mesh."""
    with jax_dryrun() as (jd, jconfigs):
        for mach in ("auto", "on", "off"):
            jcfg = jconfigs.get_config(arch, mach=mach)
            cfg = get_config(arch, mach=mach)
            n_active = jd._active_params(jcfg)
            assert dryrun._active_params(cfg) == n_active
            for shape, spec in SHAPES.items():
                kind = spec["kind"]
                tokens = (spec["seq_len"] * spec["global_batch"]
                          if kind != "decode" else spec["global_batch"])
                assert dryrun.model_flops(cfg, spec) == \
                    (6 if kind == "train" else 2) * n_active * tokens
                for axes in MESHES.values():
                    want = jd._train_cfg_for(jcfg, spec["global_batch"],
                                             _JaxMesh(axes))
                    got = dryrun._train_cfg_for(cfg, spec["global_batch"],
                                                _TorchMesh(axes))
                    assert (got.num_microbatches, got.master_weights) == \
                        (want.num_microbatches, want.master_weights)
                for fn in ("train_batch_specs", "prefill_batch_specs"):
                    want = getattr(jd, fn)(jcfg, spec["seq_len"],
                                           spec["global_batch"])
                    got = getattr(dryrun, fn)(cfg, spec["seq_len"],
                                              spec["global_batch"])
                    assert {k: (tuple(v.shape), str(v.dtype))
                            for k, v in want.items()} == \
                        {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                         for k, v in got.items()}


# A small LM where products dominate: tinyllama's smoke config at d_model
# 256, d_ff 1,024, 4 / 2 heads of 64, 2 layers, the OAA head over its 256
# tokens, float32, remat "none" (both packages run the forward once);
# 8 x 128 tokens.  The gap is the elementwise work: eager PyTorch counts
# each op's output, XLA its fused module (the softmax, norms, rotary
# embedding and AdamW's update count differently).
SMALL = dict(d_model=256, d_ff=1024, num_heads=4, num_kv_heads=2,
             head_dim=64, num_layers=2, remat="none")
SMALL_B, SMALL_T = 8, 128


def _small_pair():
    with jax_reference() as ns:
        jcfg = dataclasses.replace(ns.configs.get_config(
            "tinyllama-1.1b", smoke=True), dtype=jnp.float32, **SMALL)
        jmodel = ns.models.LanguageModel(jcfg)
        jparams = jax.eval_shape(lambda k: jmodel.init(k)[0],
                                 jax.random.key(0))
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              dtype=torch.float32, **SMALL)
    return jmodel, jparams, LanguageModel(cfg)


def _port_count(model, step):
    """``step(params, batch)`` counted on fake tensors."""
    with FakeTensorMode(), dryrun._one_resampling_round():
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.zeros((SMALL_B, SMALL_T + 1),
                                       dtype=torch.int32)}
        return analyze(step, params, batch)


def test_small_lm_forward_flops_match_jax():
    jmodel, jparams, model = _small_pair()
    jbatch = {"tokens": jax.ShapeDtypeStruct((SMALL_B, SMALL_T + 1),
                                             jnp.int32)}
    want = ha.analyze(jax.jit(jmodel.loss).lower(jparams, jbatch)
                      .compile().as_text())
    got = _port_count(model, model.loss)
    assert abs(got["flops"] / want["flops"] - 1) < 0.05, (got["flops"],
                                                          want["flops"])


def test_small_lm_train_step_flops_match_jax():
    jmodel, jparams, model = _small_pair()
    tc = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jstep, jopt = jtrainer.make_train_step(jmodel.loss,
                                           jtrainer.TrainConfig(**tc))
    jstate = jax.eval_shape(lambda p: jax_new_train_state(p, jopt), jparams)
    jbatch = {"tokens": jax.ShapeDtypeStruct((SMALL_B, SMALL_T + 1),
                                             jnp.int32)}
    want = ha.analyze(jax.jit(jstep).lower(jstate, jbatch).compile()
                      .as_text())
    step, opt = make_train_step(model.loss, TrainConfig(**tc))
    got = _port_count(model, lambda p, b: step(new_train_state(p, opt), b))
    assert abs(got["flops"] / want["flops"] - 1) < 0.05, (got["flops"],
                                                          want["flops"])


def test_peak_tracker_equals_torchs_memtracker():
    """``PeakTracker`` (the dry run's memory tracker) against torch's
    ``MemTracker`` on the small LM's train step on fake tensors, both
    entered around the same run with the same state tracked as external:
    the same peak byte for byte."""
    _, _, model = _small_pair()
    step, opt = make_train_step(model.loss, TrainConfig(
        peak_lr=1e-3, warmup_steps=2, total_steps=10))
    with FakeTensorMode(), dryrun._one_resampling_round():
        state = new_train_state(model.init(torch.Generator().manual_seed(0),
                                           "cpu"), opt)
        batch = {"tokens": torch.zeros((SMALL_B, SMALL_T + 1),
                                       dtype=torch.int32)}
        held = [x for tree in (state, batch) for _, x in tree_flatten(tree)
                if isinstance(x, torch.Tensor)]
        theirs, ours = MemTracker(), PeakTracker()
        theirs.track_external(*held)
        ours.track_external(*held)
        with theirs, ours:
            step(state, batch)
    want = max(snap["Total"] for snap in
               theirs.get_tracker_snapshot("peak").values())
    assert ours.peak == want > sum(x.nbytes for x in held)


def test_refused_cell_fails_with_the_ports_message():
    res = dryrun.lower_cell("tinyllama-1.1b", "train_4k", sp=True,
                            spec=dict(SHAPES["train_4k"], world=2,
                                      global_batch=2, seq_len=16))
    assert not res.ok and "sequence parallelism" in res.reason


def test_skipped_cell():
    res = dryrun.lower_cell("tinyllama-1.1b", "long_500k")
    assert res.ok and res.skipped and "full-attention" in res.reason


def test_entry_point_writes_a_full_width_cell(tmp_path):
    """tinyllama-1.1b's decode_32k cell at full width through the entry
    point (~5 s): rc 0 and its JSON beside the artifacts."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "tinyllama-1.1b", "--shape", "decode_32k"],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("OK tinyllama-1.1b")
    path = Path(dryrun.ARTIFACT_DIR) / "pod16x16" / \
        "tinyllama-1.1b__decode_32k.json"
    rec = json.loads(path.read_text())
    assert rec["ok"] and rec["data"]["serve_split"] is False
    mem = rec["data"]["memory"]
    # every rank holds the whole bf16 params and the 128 x 32,768 caches
    assert mem["per_device_argument_bytes"] > 2 * 1.1e9 + 128 * 32768 * 22 \
        * 2 * 4 * 64 * 2
    assert rec["data"]["kernels"] == {}        # tinyllama: the OAA head

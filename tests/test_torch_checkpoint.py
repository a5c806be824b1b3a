"""The port's checkpoints and restarts against the JAX package's.

* Format parity: a checkpoint the JAX ``CheckpointManager`` wrote
  (float32, int32 and bfloat16 leaves in nested dicts, lists and a
  ``TrainState``) restores in the port with equal values, bf16 bit for
  bit, int leaves as ints; JAX's manager restores a float32 / int32
  checkpoint the port wrote; both packages write the same manifest
  (paths, shapes, dtypes) for the same tree.  (JAX's own ``restore``
  cannot read a bf16 leaf back under the installed jax: ROADMAP §3.)
* A cross-package resume: the tiny LM of ``tests/test_train.py``
  (inside ``jax_reference()``) trained 10 steps by JAX and checkpointed;
  the port restores that checkpoint into a template built with
  ``convert.py`` (equal to JAX's state bit for bit), and both continue to
  step 20, held at ``tests/test_torch_lm_train.py``'s trainer tolerance.
* ``tests/test_train.py``'s checkpoint and restart cases on the port's
  tiny LM: round trip exact and keep-N through ``Trainer.fit(manager=)``,
  crash and restart bit for bit (blocking saves, async saves, and
  ``fit`` driven by ``run_with_restarts``), the elastic move, async saves,
  an async failure re-raised on ``wait()`` and on the next ``save()``,
  stale ``.tmp`` swept, a transient ``OSError`` retried, a persistent one
  re-raised after the last attempt, and a publish failure keeping the
  durable step; the port's own: a state mutated in place after
  ``save(blocking=False)`` restores its values from before, a leaf-count
  or shape mismatch and a corrupt array refused.
* The entry points on the CPU: ``launch/train.main`` with ``--ckpt-dir``
  (the second run resumes), ``examples/train_lm.py`` (the second run
  resumes) and ``examples/serve_lm.py``.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.core.mach import MACHConfig as JaxMACHConfig
from repro.data import LMDataConfig as JaxLMDataConfig
from repro.data import SyntheticLMStream as JaxSyntheticLMStream
from repro.optim import adamw as jax_adamw
from repro.train import trainer as jtrainer
from repro.train.train_state import TrainState as JaxTrainState
from repro_torch.checkpoint import CheckpointManager, tree_flatten
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.convert import convert_lm_params
from repro_torch.core.mach import MACHConfig
from repro_torch.data import LMDataConfig, SyntheticLMStream
from repro_torch.examples import serve_lm, train_lm
from repro_torch.launch import train as launch_train
from repro_torch.models import LanguageModel, ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import (TrainConfig, TrainState, Trainer,
                               make_optimizer_from_config, new_train_state,
                               reshard_state, run_with_restarts)
from torch_lm_cases import RTOL, leaves
from torch_reference import jax_lm  # noqa: F401  (fixture)

TINY = dict(name="tiny", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=1, d_ff=64, vocab_size=64)
CFG = ModelConfig(**TINY, dtype=torch.float32, mach=MACHConfig(64, 8, 4))
TCFG = dict(total_steps=30, warmup_steps=5, peak_lr=1e-2,
            checkpoint_every=10, log_every=1000)
DATA = dict(vocab_size=64, seq_len=16, global_batch=8)


# ---------------------------------------------------------------- helpers

def _numpy_tree(seed):
    """A tree of float32, int32 and bf16 arrays (nested dicts, a list, a
    0-d leaf, a None)."""
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((5, 3)).astype(np.float32),
            "blocks": [{"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "ids": rng.integers(-9, 9, (4,)).astype(np.int32)}
                       for _ in range(2)],
            "scale": np.float32(rng.standard_normal()),
            "a_bf16": rng.standard_normal((2, 3)).astype(np.float32),
            "none": None}


def _jax_tree(tree, bf16=True):
    def leaf(k, v):
        return jnp.asarray(v, jnp.bfloat16 if bf16 and k == "a_bf16"
                           else v.dtype)
    return _map_np(tree, leaf)


def _torch_tree(tree, bf16=True, fill=None):
    def leaf(k, v):
        t = torch.from_numpy(np.array(v))
        if bf16 and k == "a_bf16":
            t = t.to(torch.bfloat16)
        return t if fill is None else torch.full_like(t, fill)
    return _map_np(tree, leaf)


def _map_np(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _map_np(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_np(v, fn, key) for v in tree]
    return None if tree is None else fn(key, tree)


def _jax_state(tree):
    params = _jax_tree(tree)
    return JaxTrainState(jnp.asarray(7, jnp.int32), params,
                         jax_adamw(1e-3).init(params))


def _torch_state(tree, fill=None):
    params = _torch_tree(tree, fill=fill)
    return TrainState(7 if fill is None else 0, params,
                      adamw(1e-3).init(params))


def _bits(x):
    """A leaf as comparable numpy bits (bf16 through int16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same(a, b):
    pa, pb = tree_flatten(a), tree_flatten(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert type(x) is type(y) or isinstance(x, torch.Tensor), path
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, path
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=path)


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:012d}",
                           "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------- format parity

@pytest.mark.parametrize("kind", ["train_state", "tree"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, kind):
    tree = _numpy_tree(0)
    jstate = _jax_state(tree) if kind == "train_state" else _jax_tree(tree)
    JaxCheckpointManager(str(tmp_path)).save(3, jstate)
    template = (_torch_state(tree, fill=0) if kind == "train_state"
                else _torch_tree(tree, fill=0))
    got, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 3
    pairs = tree_flatten(got)
    assert [p for p, _ in pairs] == _manifest(tmp_path, 3)["paths"]
    for (path, x), want in zip(pairs, jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_bits(x), _bits(want), err_msg=path)
    if kind == "train_state":
        assert got.step == 7 and got.opt_state.count == 0
        assert type(got.step) is int and type(got.opt_state.count) is int
    bf16 = (got if kind == "tree" else got.params)["a_bf16"]
    assert bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["train_state", "tree"])
def test_port_checkpoint_restores_in_jax(tmp_path, kind):
    """JAX's manager reads a float32 / int32 checkpoint of the port's."""
    tree = _numpy_tree(1)
    if kind == "train_state":
        params = _torch_tree(tree, bf16=False)
        state = TrainState(7, params, adamw(1e-3).init(params))
        jparams = _jax_tree(tree, bf16=False)
        template = JaxTrainState(jnp.zeros((), jnp.int32),
                                 jax.tree.map(jnp.zeros_like, jparams),
                                 jax_adamw(1e-3).init(jparams))
    else:
        state = _torch_tree(tree, bf16=False)
        template = jax.tree.map(jnp.zeros_like, _jax_tree(tree, bf16=False))
    CheckpointManager(str(tmp_path)).save(5, state)
    got, step = JaxCheckpointManager(str(tmp_path)).restore(template)
    assert step == 5
    want = [x for _, x in tree_flatten(state)]
    for g, w in zip(jax.tree.leaves(got), want):
        np.testing.assert_array_equal(np.asarray(g), _bits(w))
        assert np.asarray(g).dtype == (_bits(w).dtype if isinstance(
            w, torch.Tensor) else np.int32)


@pytest.mark.parametrize("kind", ["train_state", "tree"])
def test_both_packages_write_the_same_manifest(tmp_path, kind):
    tree = _numpy_tree(2)
    jstate = _jax_state(tree) if kind == "train_state" else _jax_tree(tree)
    state = _torch_state(tree) if kind == "train_state" else _torch_tree(tree)
    JaxCheckpointManager(str(tmp_path / "jax")).save(4, jstate)
    CheckpointManager(str(tmp_path / "port")).save(4, state)
    want = _manifest(tmp_path / "jax", 4)
    assert _manifest(tmp_path / "port", 4) == want
    assert "bfloat16" in want["dtypes"] and "int32" in want["dtypes"]
    # and each package's arrays hold the same bits, leaf for leaf
    jarr = np.load(tmp_path / "jax" / "step_000000000004" / "arrays.npz")
    parr = np.load(tmp_path / "port" / "step_000000000004" / "arrays.npz")
    assert sorted(jarr.files) == sorted(parr.files)
    for name in jarr.files:
        np.testing.assert_array_equal(jarr[name].reshape(-1).view(np.uint8),
                                      parr[name].reshape(-1).view(np.uint8))


def _jax_tiny(jax_lm):
    jcfg = jax_lm.models.ModelConfig(**TINY, dtype=jnp.float32,
                                     mach=JaxMACHConfig(64, 8, 4))
    return jax_lm.models.LanguageModel(jcfg)


class _TorchBatches:
    """The JAX stream's batches as tensors (the same numbers)."""

    def __init__(self, jstream):
        self.jstream = jstream

    def batch_at(self, step):
        return {k: torch.from_numpy(np.array(v))
                for k, v in self.jstream.batch_at(step).items()}


def test_cross_package_resume(jax_lm, tmp_path):
    """JAX trains 10 steps and checkpoints; the port restores that into a
    template built with convert.py, and both go on to step 20."""
    jtr = jtrainer.Trainer(_jax_tiny(jax_lm), jtrainer.TrainConfig(**TCFG))
    model = LanguageModel(CFG)
    tr = Trainer(model, TrainConfig(**TCFG))
    jstate = jtr.init_state(jax.random.key(0))
    template = new_train_state(convert_lm_params(
        model, jax.tree.map(np.asarray, jstate.params), device="cpu"), tr.opt)
    jstream = JaxSyntheticLMStream(JaxLMDataConfig(**DATA))
    jstate = jtr.fit(jstate, jstream, 10,
                     manager=JaxCheckpointManager(str(tmp_path)), log=None)
    state, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 10 and state.step == 10 and state.opt_state.count == 10
    got = tree_flatten(state)
    assert len(got) == len(jax.tree.leaves(jstate))
    for (path, x), want in zip(got, jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_bits(x), np.asarray(want),
                                      err_msg=path)
    state = tr.fit(state, _TorchBatches(jstream), 10, log=None)
    jstate = jtr.fit(jstate, jstream, 10, log=None)
    assert state.step == int(jstate.step) == 20
    _, sched = make_optimizer_from_config(TrainConfig(**TCFG))
    lr_sum = sum(float(sched(s)) for s in range(10, 20))
    want = convert_lm_params(model, jax.tree.map(np.asarray, jstate.params),
                             device="cpu")
    off = total = 0
    for got, w in zip(leaves(state.params), leaves(want)):
        err = (got - w).abs()
        assert float(err.max()) <= 2 * lr_sum
        off += int((err > RTOL * float(w.abs().max())).sum())
        total += err.numel()
    assert off <= 1e-4 * total, off


# -------------------------------------------- tests/test_train.py, ported

@pytest.fixture(scope="module")
def stream():
    return SyntheticLMStream(LMDataConfig(**DATA), device="cpu")


def _trainer(**overrides):
    return Trainer(LanguageModel(CFG), TrainConfig(**dict(TCFG, **overrides)))


def _init(tr):
    return tr.init_state(torch.Generator().manual_seed(0), "cpu")


def test_checkpoint_roundtrip_exact(stream, tmp_path):
    tr = _trainer()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = tr.fit(_init(tr), stream, 25, manager=mgr, log=None)
    restored, step = mgr.restore(_init(tr))
    assert step == 25
    _assert_same(restored, state)
    # keep=2 garbage collection: the periodic save at 20, the final at 25
    assert mgr.all_steps() == [20, 25]


class _Failing:
    """A stream that fails once, at ``step``, after ``manager``'s latest
    save is durable (a node lost after the first checkpoint)."""

    def __init__(self, inner, step, manager):
        self.inner, self.step, self.manager = inner, step, manager
        self.failed = False

    def batch_at(self, s):
        if s == self.step and not self.failed:
            self.failed = True
            self.manager.wait()
            raise RuntimeError("injected node failure")
        return self.inner.batch_at(s)


@pytest.mark.parametrize("mode", ["blocking", "async", "fit"])
def test_crash_restart_bit_exact(stream, tmp_path, mode):
    """Kill training mid-run; the restarted run must produce the SAME
    final state as an uninterrupted one (deterministic data cursor +
    durable checkpoints), with blocking saves, async saves, and through
    ``Trainer.fit(manager=)``."""

    def run(crash, directory):
        mgr = CheckpointManager(directory, keep=3)
        tr = _trainer()
        calls = {"n": 0}
        failing = _Failing(stream, 17 if crash else -1, mgr)

        def train_once(state, remaining):
            calls["n"] += 1
            if mode == "fit":
                return tr.fit(state, failing, remaining, manager=mgr,
                              log=None)
            for s in range(state.step, 30):
                state, _ = tr.step_fn(state, stream.batch_at(s))
                if (s + 1) % 10 == 0:
                    mgr.save(s + 1, state, blocking=mode == "blocking")
                if crash and calls["n"] == 1 and s == 17:
                    mgr.wait()
                    raise RuntimeError("injected node failure")
            return state

        final = run_with_restarts(train_once, lambda: _init(tr), mgr, 30,
                                  log=None)
        return final, calls["n"]

    f_ok, n1 = run(False, str(tmp_path / "ok"))
    f_crash, n2 = run(True, str(tmp_path / "crash"))
    assert n1 == 1 and n2 == 2
    _assert_same(f_crash, f_ok)


def test_elastic_reshard_roundtrip(tmp_path):
    """A checkpoint saved anywhere restores onto the device asked for —
    here from a template on the meta device (no memory) onto the CPU."""
    tr = _trainer()
    state = _init(tr)
    _assert_same(reshard_state(state, "cpu"), state)
    on_meta = reshard_state(state, "meta")
    assert leaves(on_meta.params)[0].device.type == "meta"
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    restored, _ = mgr.restore(on_meta, device="cpu")
    _assert_same(restored, state)


def test_async_checkpoint_save(tmp_path):
    state = _init(_trainer())
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, state, blocking=False)
    mgr.save(2, state, blocking=False)   # waits for save 1 internally
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    assert mgr.latest_step() == 2
    assert not mgr.in_flight()


@pytest.mark.parametrize("surfaces_on", ["wait", "save"])
def test_async_save_failure_raises(tmp_path, surfaces_on):
    """A failed background save must surface on the next wait()/save(),
    never be reported durable, and leave the manager usable."""
    state = {"a": torch.arange(4)}
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    # a regular *file* where the writer wants its .tmp dir: removing it
    # raises inside the background thread
    blocker = os.path.join(d, "step_000000000007.tmp")
    with open(blocker, "w") as f:
        f.write("in the way")
    mgr.save(7, state, blocking=False)
    with pytest.raises(NotADirectoryError):
        if surfaces_on == "wait":
            mgr.wait()
        else:
            mgr.save(8, state)               # wait() runs first and raises
    assert mgr.latest_step() is None         # failure not durable
    # the captured failure is cleared once raised; the manager recovers
    os.remove(blocker)
    mgr.save(8, state, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 8


def test_stale_tmp_dirs_swept_by_gc(tmp_path):
    """step_*.tmp left by a crashed writer is GC'd by the next durable
    save (and never shows up as a restorable step)."""
    d = str(tmp_path)
    stale = os.path.join(d, "step_000000000001.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "junk"), "w") as f:
        f.write("partial write")
    mgr = CheckpointManager(d, keep=2)
    assert mgr.all_steps() == []             # .tmp never restorable
    mgr.save(2, {"a": torch.arange(4)}, blocking=True)
    assert not os.path.exists(stale)
    assert mgr.latest_step() == 2


def test_checkpoint_save_retries_transient_fs_errors(tmp_path, monkeypatch):
    """Bounded retry with backoff: two transient FS failures, the third
    attempt lands; the checkpoint is durable and wait() is clean."""
    mgr = CheckpointManager(str(tmp_path), save_retries=3, retry_backoff=0.0)
    calls = {"n": 0}
    orig = manager_mod._write_npz

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("transient fs hiccup")
        return orig(*a, **k)

    monkeypatch.setattr(manager_mod, "_write_npz", flaky)
    mgr.save(7, {"w": torch.arange(6.0)}, blocking=False)
    mgr.wait()                                   # must not raise
    assert calls["n"] == 3
    restored, step = mgr.restore({"w": torch.zeros(6)})
    assert step == 7
    assert torch.equal(restored["w"], torch.arange(6.0))


def test_checkpoint_save_reraises_after_final_attempt(tmp_path, monkeypatch):
    """A persistent failure exhausts the retry budget and re-raises —
    async on the next wait(), blocking immediately."""
    state = {"w": torch.arange(3.0)}
    mgr = CheckpointManager(str(tmp_path), save_retries=2, retry_backoff=0.0)
    calls = {"n": 0}

    def always_fails(*a, **k):
        calls["n"] += 1
        raise OSError("disk on fire")

    monkeypatch.setattr(manager_mod, "_write_npz", always_fails)
    mgr.save(1, state, blocking=False)
    with pytest.raises(OSError, match="disk on fire"):
        mgr.wait()
    assert calls["n"] == 2                       # bounded, not infinite
    calls["n"] = 0
    with pytest.raises(OSError, match="disk on fire"):
        mgr.save(2, state, blocking=True)
    assert calls["n"] == 2
    assert mgr.all_steps() == []                 # nothing half-written shows


def test_checkpoint_publish_failure_never_destroys_durable_step(
        tmp_path, monkeypatch):
    """A failure after the rename (LATEST pointer / GC) must not re-enter
    the step write: the durable step dir survives, and restore() finds it
    by the directory scan."""
    mgr = CheckpointManager(str(tmp_path), save_retries=2, retry_backoff=0.0)
    orig = os.rename

    def flaky_rename(src, dst):
        if dst.endswith("LATEST"):
            raise OSError("LATEST write failed")
        return orig(src, dst)

    monkeypatch.setattr(manager_mod.os, "rename", flaky_rename)
    mgr.save(3, {"w": torch.arange(5.0)}, blocking=False)
    with pytest.raises(OSError, match="LATEST write failed"):
        mgr.wait()
    monkeypatch.setattr(manager_mod.os, "rename", orig)
    assert mgr.all_steps() == [3]
    restored, step = mgr.restore({"w": torch.zeros(5)})
    assert step == 3
    assert torch.equal(restored["w"], torch.arange(5.0))


# ------------------------------------------------------ the port's own

def test_async_save_is_a_snapshot(stream, tmp_path, monkeypatch):
    """The state mutated in place after save(blocking=False) returns (an
    AdamW step, which updates the moments in place, and params bumped in
    place) restores its values from before the save.  The writer is held
    until the mutation is done."""
    tr = _trainer()
    state = tr.fit(_init(tr), stream, 2, log=None)
    before = tree_flatten(state)
    before = [(p, x.clone() if isinstance(x, torch.Tensor) else x)
              for p, x in before]
    gate = threading.Event()
    orig = manager_mod._write_npz

    def held(*a, **k):
        assert gate.wait(30)
        return orig(*a, **k)

    monkeypatch.setattr(manager_mod, "_write_npz", held)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, blocking=False)
    mu = leaves(state.opt_state.mu)[0]
    mu_before = mu.clone()
    tr.step_fn(state, stream.batch_at(2))        # moments move in place
    for p in leaves(state.params):
        p.add_(1.0)
    assert not torch.equal(mu, mu_before)        # the hazard is real
    gate.set()
    mgr.wait()
    restored, _ = mgr.restore(_init(tr))
    for (path, want), (_, got) in zip(before, tree_flatten(restored)):
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=path)


@pytest.mark.parametrize("change", ["leaf_count", "shape"])
def test_restore_refuses_another_structure(tmp_path, change):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3), "b": [torch.zeros(2, 2), 5]})
    template = ({"a": torch.zeros(3), "b": [torch.zeros(2, 2)]}
                if change == "leaf_count"
                else {"a": torch.zeros(3), "b": [torch.zeros(2, 3), 0]})
    with pytest.raises(ValueError, match="leaves" if change == "leaf_count"
                       else r"\['b'\]\[0\] has shape"):
        mgr.restore(template)


def test_restore_refuses_a_corrupt_array(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(1000.0)})
    path = tmp_path / "step_000000000001" / "arrays.npz"
    raw = bytearray(path.read_bytes())
    at = raw.index(np.float32(500.0).tobytes())
    raw[at] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32"):
        mgr.restore({"w": torch.zeros(1000)})


# ------------------------------------------------------- entry points

def test_launch_train_resumes_from_its_ckpt_dir(tmp_path, capsys):
    args = ["--device", "cpu", "--seq-len", "16", "--global-batch", "2",
            "--ckpt-dir", str(tmp_path)]
    assert launch_train.main(args + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "step 5: loss=" in out and "finished at step 6 on cpu" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [5, 6]
    assert launch_train.main(args + ["--steps", "8"]) == 0
    out = capsys.readouterr().out
    assert "[ft] restored checkpoint at step 6" in out
    assert "finished at step 8 on cpu" in out


def test_train_lm_example_resumes(tmp_path, capsys, monkeypatch):
    """The ~100M-parameter example's code at a narrow width (its config
    swapped for a 2-layer, d=64 one); the second run resumes."""
    import dataclasses
    lm100m = train_lm.model_config

    def narrow(vocab, mach):
        return dataclasses.replace(
            lm100m(vocab, mach), num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, mach=MACHConfig(vocab, 16, 4))

    monkeypatch.setattr(train_lm, "model_config", narrow)
    args = ["--device", "cpu", "--seq-len", "16", "--batch", "2", "--vocab",
            "256", "--ckpt-dir", str(tmp_path)]
    assert train_lm.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed" not in out and "done at step 3" in out
    assert train_lm.main(args + ["--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 3" in out
    assert "done at step 5" in out


@pytest.mark.parametrize("page_size", [0, 16])
def test_serve_lm_example_runs_on_the_cpu(capsys, page_size):
    assert serve_lm.main(["--device", "cpu", "--page-size",
                          str(page_size)]) == 0
    out = capsys.readouterr().out
    assert "5 requests" in out and out.count("sampled") == 4
    assert ("page pool:" in out) == bool(page_size)

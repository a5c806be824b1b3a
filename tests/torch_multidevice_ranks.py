"""The rank side of ``test_torch_multidevice.py``: CPU ``gloo`` worlds of
2 and 4 processes that train, checkpoint and serve through the port's
mesh paths beside the single-device port, and write what they measured
for the test process to hold.  No JAX here: each rank imports only
torch and the port.

``spawn_world(world, name, directory, timeout)`` starts ``world``
processes (``spawn``), each running ``RANK_FNS[name](rank, directory)``
inside a process group on a file store, and joins them by a deadline,
killing any left; rank 0's returned dict is saved to
``<directory>/<name>.pt``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import multiprocessing
import os
import time

import torch
import torch.distributed as dist

THREADS = 2


def spawn_world(world: int, name: str, directory: str,
                timeout: float) -> dict:
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(directory, f"{name}.store")
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, store, name, directory))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise TimeoutError(f"world {name}: ranks {hung} still running after "
                           f"{timeout} s (killed)")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"world {name}: exit codes {codes} (see the "
                           f"ranks' stderr above)")
    # written by this world's rank 0 just now
    return torch.load(os.path.join(directory, f"{name}.pt"),
                      weights_only=False)


def _rank_main(rank, world, store, name, directory):
    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = RANK_FNS[name](rank, directory)
        if rank == 0:
            torch.save(out, os.path.join(directory, f"{name}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- pieces

def model_config(arch, **overrides):
    """The smoke config of ``arch`` in float32 (params and activations)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32, **overrides)


def train_config(**kw):
    from repro_torch.train import TrainConfig
    base = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    return TrainConfig(**{**base, **kw})


def batches(cfg, n, global_batch=4, seq=16, weighted=False, seed=0):
    """``n`` global batches of the entry point's stream; with
    ``weighted``, 0/1 weights whose sums differ between the halves."""
    from repro_torch.launch import train as launch_train
    stream = launch_train.data_stream(cfg, seq, global_batch, seed, "cpu")
    out = []
    for s in range(n):
        b = stream.batch_at(s)
        if weighted:
            g = torch.Generator().manual_seed(seed + s)
            keep = torch.rand((global_batch, seq), generator=g)
            keep[: global_batch // 2] = keep[: global_batch // 2] < 0.2
            keep[global_batch // 2:] = keep[global_batch // 2:] < 0.9
            b["weights"] = keep
        out.append(b)
    return out


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def sharded_vs_one_device(model_cfg, tcfg, mesh, steps_batches, rules=None):
    """The same steps through ``Trainer(mesh=)`` and the single-device
    ``Trainer`` from one seed: per step both metrics dicts, then the
    gathered final params and the single device's."""
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import gather
    from repro_torch.train import Trainer
    model = LanguageModel(model_cfg)
    sharded = Trainer(model, tcfg, mesh=mesh, rules=rules)
    single = Trainer(model, tcfg)
    gen = lambda: torch.Generator().manual_seed(0)   # noqa: E731
    st, rs = sharded.init_state(gen(), "cpu"), single.init_state(gen(), "cpu")
    metrics = []
    for b in steps_batches:
        st, m = sharded.step_fn(st, b)
        rs, rm = single.step_fn(rs, b)
        metrics.append((_metrics(m), _metrics(rm)))
    return {"metrics": metrics, "params": gather(st.params),
            "want": rs.params, "state": st}


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


class _FailOnce:
    """A stream that raises once at ``step``, after the manager's last
    save is durable."""

    def __init__(self, batches, step, manager):
        self.batches, self.step, self.manager = batches, step, manager
        self.failed = False

    def batch_at(self, s):
        if s == self.step and not self.failed:
            self.failed = True
            self.manager.wait()
            raise RuntimeError(f"injected failure at step {s + 1}")
        return self.batches[s]


# ----------------------------------------------------------------- worlds

def world2(rank, directory):
    """Mesh (2, 1): AdamW, Adafactor, uneven weights, MoE, the fused MACH
    loss, a bf16 run, checkpoints, a restart, the entry points."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import ShardingRules, gather, resolve_spec
    from repro_torch.train import Trainer, run_with_restarts

    mesh = _mesh((2, 1))
    out = {}
    tiny = model_config("tinyllama-1.1b")
    adamw = sharded_vs_one_device(tiny, train_config(), mesh,
                                  batches(tiny, 3))
    out["adamw"] = {k: adamw[k] for k in ("metrics", "params", "want")}
    out["adafactor"] = _strip(sharded_vs_one_device(
        tiny, train_config(optimizer="adafactor", peak_lr=1e-2), mesh,
        batches(tiny, 1)))
    out["weighted"] = _strip(sharded_vs_one_device(
        tiny, train_config(), mesh, batches(tiny, 2, weighted=True)))
    out["microbatches"] = _strip(sharded_vs_one_device(
        tiny, train_config(num_microbatches=2), mesh,
        batches(tiny, 2, weighted=True, seed=5)))
    moe = model_config("qwen2-moe-a2.7b")
    out["moe"] = _strip(sharded_vs_one_device(moe, train_config(), mesh,
                                              batches(moe, 2)))
    fused = model_config("recurrentgemma-2b", mach_fused_loss=True)
    out["fused"] = _strip(sharded_vs_one_device(fused, train_config(), mesh,
                                                batches(fused, 2)))
    bf16 = dataclasses.replace(tiny, dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
    out["bf16"] = _strip(sharded_vs_one_device(bf16, train_config(), mesh,
                                               batches(bf16, 2)))
    out["mesh_view"] = resolve_spec(
        mesh, ShardingRules().table(mesh), ("embed", "mlp"), (64, 128))

    # the sharded AdamW state saved at world 2, blocking and not
    ckpt = os.path.join(directory, "ckpt_world2")
    mgr = CheckpointManager(ckpt)
    mgr.save(3, adamw["state"])
    mgr.save(4, adamw["state"], blocking=False)
    mgr.wait()
    out["ckpt_steps"] = mgr.all_steps()
    out["saved_state"] = gather(adamw["state"])

    # run_with_restarts on the mesh: a failure after the step-2 save
    tcfg = train_config(checkpoint_every=2, log_every=100)
    trainer = Trainer(LanguageModel(tiny), tcfg, mesh=mesh)
    data = batches(tiny, 4)

    def init():
        return trainer.init_state(torch.Generator().manual_seed(0), "cpu")

    mgr = CheckpointManager(os.path.join(directory, "restart"))
    flaky = _FailOnce(data, 2, mgr)
    logs = []
    restarted = run_with_restarts(
        lambda st, n: trainer.fit(st, flaky, n, manager=mgr, log=None),
        init, mgr, 4, log=logs.append)
    straight = trainer.fit(init(), _FailOnce(data, -1, mgr), 4, log=None)
    out["restart"] = {"logs": logs, "restarted": gather(restarted),
                      "straight": gather(straight)}

    # the entry points on this world
    ck = os.path.join(directory, "launch_world2")
    out["launch"] = _stdout(launch_train.main, [
        "--local", "--device", "cpu", "--steps", "3", "--seq-len", "16",
        "--global-batch", "4", "--ckpt-dir", ck])
    out["serve"] = _stdout(launch_serve.main, ["--local", "--device", "cpu",
                                               "--requests", "3"])
    return out


def _strip(res):
    return {k: res[k] for k in ("metrics", "params", "want")}


def world4(rank, directory):
    """Meshes (4, 1), (2, 2) and (2, 2, 1) with a pod axis; the world-2
    checkpoint restored here; a state moved between meshes; the rows a
    rank holds of a dim over (pod, data)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import (ShardingRules, gather, placements,
                                      state_shardings)
    from repro_torch.train import Trainer, reshard_state

    out = {}
    tiny = model_config("tinyllama-1.1b")
    data = batches(tiny, 3)
    m41, m22 = _mesh((4, 1)), _mesh((2, 2))
    out["mesh4x1"] = _strip(sharded_vs_one_device(tiny, train_config(), m41,
                                                  data))
    out["mesh2x2"] = _strip(sharded_vs_one_device(tiny, train_config(), m22,
                                                  data))
    pod = _mesh((2, 2, 1), ("pod", "data", "model"))
    out["pod"] = _strip(sharded_vs_one_device(
        tiny, train_config(), pod, batches(tiny, 2, global_batch=8)))

    # the world-2 checkpoint into world-4 templates and by shardings=
    model = LanguageModel(tiny)
    trainer = Trainer(model, train_config(), mesh=m41)
    template = trainer.init_state(torch.Generator().manual_seed(1), "cpu")
    mgr = CheckpointManager(os.path.join(directory, "ckpt_world2"))
    restored, step = mgr.restore(template, 3)
    out["restored_step"] = step
    out["restored"] = gather(restored)
    out["restored_is_sharded"] = all(
        type(x).__name__ == "DTensor" for x in _tensor_leaves(restored))
    _, on22, _ = state_shardings(m22, ShardingRules(), model, trainer.opt)
    plain = Trainer(model, train_config()).init_state(
        torch.Generator().manual_seed(1), "cpu")
    by_spec, _ = mgr.restore(plain, 3, shardings=on22)
    out["restored_by_shardings"] = gather(by_spec)
    moved = reshard_state(restored, on22)
    out["resharded"] = gather(moved)
    # (global shape, the tensor dim each mesh dim splits, local shape)
    out["layout_2x2"] = [
        (tuple(x.shape), [getattr(p, "dim", None) for p in x.placements],
         tuple(x.to_local().shape))
        for state in (by_spec, moved) for x in _tensor_leaves(state)]

    # rows of a (8, 3) tensor whose dim 0 is split over (pod, data)
    pd = _mesh((2, 2), ("pod", "data"))
    x = torch.arange(24.0).reshape(8, 3)
    spec = (("pod", "data"),)
    local = distribute_tensor(x, pd, placements(spec, pd),
                              src_data_rank=None).to_local()
    rows = [None] * 4
    dist.all_gather_object(rows, (tuple(pd.get_coordinate()),
                                  local[:, 0].div(3).long().tolist()))
    out["pod_data_rows"] = rows
    return out


def _tensor_leaves(state):
    from repro_torch.checkpoint import tree_flatten
    return [x for _, x in tree_flatten(state) if isinstance(x, torch.Tensor)]


RANK_FNS = {"world2": world2, "world4": world4}

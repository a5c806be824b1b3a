"""Dry run of the production meshes: rank 0 of each (arch × shape) cell
at full width, on fake tensors in a fake world — the counterpart of the
JAX package's ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch mistral-large-123b --shape train_4k          # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all # the sweep

The JAX package lowers each cell over 512 placeholder devices and reads
XLA's per-device cost and memory analyses.  The port runs one step of
rank 0 eagerly: a ``"fake"`` process group of 256 ranks (the (16, 16)
mesh) or 512 ((2, 16, 16)), the port's ``make_production_mesh`` over
it, and every tensor a fake one (``FakeTensorMode``: shapes, dtypes and
a device, no data, nothing allocated), so a 123 B model runs on a laptop.
The collectives run on fake tensors through
``torch.distributed._tools.fake_collectives``; each hand-written kernel
runs its stand-in and records its ``work()`` (``kernels/counting.py``).
The step runs under ``cost_analysis.CostCounter`` (flops, bytes,
collectives) and ``cost_analysis.PeakTracker`` (the per-rank memory, as
torch's ``MemTracker`` counts it).  ``torch.distributed._tools`` and
``torch.testing._internal.distributed.fake_pg`` are private torch
modules; only this module and ``launch/cost_analysis.py`` import them.

How a cell runs (the port's own paths, nothing else):

* train: ``Trainer(mesh=, rules=ShardingRules(fsdp=True, sp=False))``
  (``make_train_step`` with ``DataParallel``), the state placed by
  ``state_shardings`` as ``Trainer.init_state`` draws it, one step on
  the global batch under ``activate(mesh, rules)``, as
  ``launch/train.py`` runs it.  ``init_peak_bytes`` is the draw's peak:
  every rank draws the whole params before it keeps its shards.
* prefill / decode: as ``launch/serve.py`` serves on a mesh today, the
  params placed and gathered whole and every rank serving the same
  requests, so a rank's figures are one device's (``"serve_split":
  false``); one step of ``make_serve_step_fn(model, top_k=8)`` with
  greedy operands (prefill over the whole batch; decode one pooled step
  over the caches, ``--page-size`` / ``--num-pages`` for the paged
  pool).

Data-dependent ops: the step paths have none.  The one in the draw,
``torch.nn.init.trunc_normal_``'s rejection loop (``mask.any()``), runs
here as one resampling round (``_one_resampling_round``), the same
allocations as each round of the real loop; any other data-dependent op
fails the cell with the op named.  Cells the port refuses (``--sp on``:
``Trainer`` refuses ``rules.sp``) fail with the port's message.

Every figure in a cell's JSON is arithmetic on the H100 data-sheet
constants of ``launch/mesh.py`` (989 TFLOP/s bf16, 3.35 TB/s HBM, 450
GB/s NVLink, 80 GB), not a measurement.  ``collective_s`` assumes
NVLink 4 between every pair of ranks: a lower bound.  Artifacts go to
``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.checkpoint import tree_flatten
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import cost_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import LanguageModel
from repro_torch.models.frontends import AUDIO_FEATURE_DIM, VISION_FEATURE_DIM
from repro_torch.serving.engine import make_serve_step_fn
from repro_torch.sharding import (ShardingRules, activate, gather,
                                  params_shardings, place)
from repro_torch.train import TrainConfig, Trainer

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
SERVE_TOP_K = 8
# --all: seconds a cell's subprocess may run (xlstm-350m's train_4k
# cells take hours: its sLSTM is an eager loop over every token, each
# step's ops run on fake tensors one by one)
CELL_TIMEOUT_S = 5 * 3600


# ---------------------------------------------------------------------------
# input specs — (shape, dtype) stand-ins for every model input
# ---------------------------------------------------------------------------

class Spec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def train_batch_specs(cfg, seq_len: int, global_batch: int) -> dict:
    specs = {}
    text_len = seq_len
    if cfg.frontend == "vision":
        text_len = seq_len - cfg.num_prefix_tokens
        specs["prefix_feats"] = Spec((global_batch, cfg.num_prefix_tokens,
                                      VISION_FEATURE_DIM), torch.float32)
    specs["tokens"] = Spec((global_batch, text_len + 1), torch.int32)
    if cfg.num_encoder_layers:
        # audio frames are length-adapted ~4x shorter than target text
        specs["enc_feats"] = Spec((global_batch, max(1, seq_len // 4),
                                   AUDIO_FEATURE_DIM), torch.float32)
    return specs


def prefill_batch_specs(cfg, seq_len: int, global_batch: int) -> dict:
    specs = train_batch_specs(cfg, seq_len, global_batch)
    gb, n = specs["tokens"].shape
    specs["tokens"] = Spec((gb, n - 1), torch.int32)
    return specs


def _make(specs: dict, device) -> dict:
    """Tensors of ``specs`` (fake under the dry run's fake mode)."""
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in specs.items()}


# ---------------------------------------------------------------------------
# cell lowering
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    skipped: bool = False
    reason: str = ""
    seconds: float = 0.0
    data: Optional[dict] = None


def _mesh_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def _train_cfg_for(cfg, global_batch: int, mesh) -> TrainConfig:
    data_size = _mesh_size(mesh, "data") * _mesh_size(mesh, "pod")
    if cfg.d_model >= 12288 or cfg.num_experts >= 8:
        micro = 16                       # 100B-class: 1 row/device/micro
    elif cfg.d_model >= 6144:
        micro = 8
    else:
        micro = 4
    while micro > 1 and (global_batch % (micro * data_size)) != 0:
        micro //= 2
    return TrainConfig(optimizer="adamw", num_microbatches=micro,
                       master_weights=cfg.param_dtype is not None,
                       total_steps=10_000, warmup_steps=500)


def _active_params(cfg) -> int:
    """Active (per-token) params: MoE counts top-k + shared experts only."""
    total = cfg.param_count_estimate()
    if not cfg.num_experts:
        return total
    mo = cfg.moe_d_ff or cfg.d_ff
    per_layer_all = cfg.num_experts * 3 * cfg.d_model * mo
    per_layer_act = cfg.experts_top_k * 3 * cfg.d_model * mo
    n_moe_layers = sum(1 for k in cfg.layout() if k == "moe")
    return total - n_moe_layers * (per_layer_all - per_layer_act)


def model_flops(cfg, spec: dict) -> int:
    """6·N·D for training, 2·N·D for inference (N active params, D the
    step's tokens: seq_len · batch, a decode step one a row)."""
    tokens = spec["global_batch"] * (spec["seq_len"]
                                     if spec["kind"] != "decode" else 1)
    return (6 if spec["kind"] == "train" else 2) * _active_params(cfg) * tokens


@contextlib.contextmanager
def _one_resampling_round():
    """``torch.nn.init.trunc_normal_`` as one round of its rejection loop
    (draw, mask the values outside [a, b], redraw them once), for the
    block: fake tensors cannot answer the loop's ``mask.any()``.  Each
    round of the real loop allocates the same, so the draw's peak is the
    real one; the values are not the real draw's (fake tensors have
    none)."""
    real = torch.nn.init.trunc_normal_

    def one_round(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
        with torch.no_grad():
            r = tensor.normal_(mean, std, generator=generator)
            redraw = torch.empty_like(r).normal_(mean, std,
                                                 generator=generator)
            tensor.copy_(torch.where((r < a) | (r > b), redraw, r))
        return tensor

    torch.nn.init.trunc_normal_ = one_round
    try:
        yield
    finally:
        torch.nn.init.trunc_normal_ = real


def _storage_bytes(*trees) -> int:
    """Bytes of the distinct storages the tensor leaves of ``trees`` hold
    (a ``DTensor``'s local shard)."""
    seen, total = set(), 0
    for tree in trees:
        for _, x in tree_flatten(tree):
            if isinstance(x, DTensor):
                x = x.to_local()
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                if id(st) not in seen:
                    seen.add(id(st))
                    total += st.nbytes()
    return total


def _memory_record(args_bytes: int, peak: int, out_bytes: int,
                   init_peak: int) -> dict:
    """Per-rank memory of the step (arguments, the tracked peak, the
    outputs) and of the draw.  ``fits_hbm``: the step's peak within one
    H100's 80 GB; ``fits_hbm_at_init`` the draw's."""
    return {
        "per_device_peak_bytes": int(peak),
        "per_device_argument_bytes": int(args_bytes),
        "per_device_temp_bytes": int(peak - args_bytes),
        "per_device_output_bytes": int(out_bytes),
        "init_peak_bytes": int(init_peak),
        "fits_hbm": bool(peak <= mesh_lib.HBM_PER_CHIP),
        "fits_hbm_at_init": bool(init_peak <= mesh_lib.HBM_PER_CHIP),
    }


def _run_step(step, args_trees):
    """``step()`` under a ``CostCounter`` and a ``PeakTracker`` that knows
    ``args_trees``: (its outputs, the counts, the peak)."""
    tracker = cost_analysis.PeakTracker()
    tracker.track_external(*[x.to_local() if isinstance(x, DTensor) else x
                             for tree in args_trees
                             for _, x in tree_flatten(tree)
                             if isinstance(x, torch.Tensor)])
    with tracker, cost_analysis.CostCounter() as counter:
        out = step()
    return out, counter, tracker.peak


def _train_cell(model, cfg, mesh, rules, spec, dev):
    tcfg = spec.get("train_config") or _train_cfg_for(
        cfg, spec["global_batch"], mesh)
    if "num_microbatches" in spec:
        tcfg = dataclasses.replace(
            tcfg, num_microbatches=spec["num_microbatches"])
    trainer = Trainer(model, tcfg, mesh=mesh, rules=rules)
    with cost_analysis.PeakTracker() as init_tracker:
        state = trainer.init_state(torch.Generator(dev).manual_seed(0), dev)
    init_peak = init_tracker.peak
    batch = _make(train_batch_specs(cfg, spec["seq_len"],
                                    spec["global_batch"]), dev)
    with activate(mesh, rules):
        (new_state, metrics), counter, peak = _run_step(
            lambda: trainer.step_fn(state, batch), (state, batch))
    return (counter, _storage_bytes(state, batch), peak,
            _storage_bytes(new_state, metrics), init_peak,
            {"num_microbatches": tcfg.num_microbatches,
             "master_weights": tcfg.master_weights})


def _serve_params(model, mesh, rules, dev):
    with activate(mesh, rules):
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        return gather(place(params, params_shardings(
            mesh, rules, model.param_axes(), params)))


def _greedy_operands(cfg, b: int) -> tuple:
    """The serve step's greedy per-row operands (seed, salts, token
    indices, temperatures, row top-k, estimator choice; the estimator):
    temperature 1e-6 over each row's candidates, as the engine's greedy
    rows."""
    est = cfg.mach.estimator if cfg.mach is not None else "unbiased"
    zeros = np.zeros((b,), np.int64)
    return (0, zeros, zeros, np.full((b,), 1e-6, np.float32),
            np.ones((b,), np.int64), zeros), est


def _prefill_cell(model, cfg, mesh, rules, spec, dev):
    with cost_analysis.PeakTracker() as init_tracker:
        params = _serve_params(model, mesh, rules, dev)
    init_peak = init_tracker.peak
    batch = _make(prefill_batch_specs(cfg, spec["seq_len"],
                                      spec["global_batch"]), dev)
    gb = batch["tokens"].shape[0]
    operands, est = _greedy_operands(cfg, gb)
    serve_step = make_serve_step_fn(model, top_k=SERVE_TOP_K)

    def step():
        enc_kvs = None
        if "enc_feats" in batch:
            with torch.no_grad():       # as the engine encodes a request
                enc_kvs = model.enc_kvs(params, model.encode(
                    params, batch["enc_feats"]))
        return serve_step(params, None, batch["tokens"], None, *operands,
                          estimators=(est,), max_len=spec["seq_len"] + 64,
                          enc_kvs=enc_kvs,
                          prefix_feats=batch.get("prefix_feats"))

    out, counter, peak = _run_step(step, (params, batch))
    return (counter, _storage_bytes(params, batch), peak,
            _storage_bytes(*out), init_peak, {})


def _decode_cell(model, cfg, mesh, rules, spec, dev, page_size, num_pages):
    gb, s = spec["global_batch"], spec["seq_len"]
    pages = (num_pages or gb * (-(-s // page_size))) if page_size else 0
    with cost_analysis.PeakTracker() as init_tracker:
        params = _serve_params(model, mesh, rules, dev)
        if page_size:
            caches = model.init_paged_caches(gb, s, page_size, pages,
                                             device=dev)
        else:
            caches = model.init_caches(gb, s, device=dev)
        enc_kvs = None
        if cfg.num_encoder_layers:
            with torch.no_grad():
                enc_kvs = model.enc_kvs(params, torch.zeros(
                    (gb, max(1, s // 4), cfg.d_model), dtype=cfg.dtype,
                    device=dev))
    init_peak = init_tracker.peak
    tokens = torch.zeros((gb, 1), dtype=torch.int64, device=dev)
    pos = torch.zeros((gb,), dtype=torch.int64, device=dev)
    operands, est = _greedy_operands(cfg, gb)
    serve_step = make_serve_step_fn(model, top_k=SERVE_TOP_K)
    out, counter, peak = _run_step(
        lambda: serve_step(params, caches, tokens, pos, *operands,
                           estimators=(est,), max_len=s, enc_kvs=enc_kvs),
        (params, caches, enc_kvs, tokens, pos))
    return (counter, _storage_bytes(params, caches, enc_kvs, tokens, pos),
            peak, _storage_bytes(*out), init_peak,
            {"page_size": page_size, "num_pages": pages})


def mesh_name(spec: dict, multi_pod: bool = False) -> str:
    """A cell's mesh label: pod16x16, pod2x16x16, or world<n>[x<m>] for a
    ``spec`` that names its own world (and model axis)."""
    if "world" not in spec:
        return "pod2x16x16" if multi_pod else "pod16x16"
    m = spec.get("model_axis", 1)
    return f"world{spec['world']}" + (f"x{m}" if m > 1 else "")


def dry_step(cfg, spec: dict, rules: ShardingRules, *,
             multi_pod: bool = False, device="cpu", page_size: int = 0,
             num_pages: int = 0) -> dict:
    """Rank 0's step of model config ``cfg`` at ``spec`` (seq_len,
    global_batch, kind) on fake tensors on ``device``, in a fake world set
    up and torn down around it: 256 ranks on the (16, 16) production mesh
    (512 on (2, 16, 16) with ``multi_pod``), or, where ``spec`` names a
    ``world``, a ``make_local_mesh(spec["model_axis"])`` (default 1) over
    that many.  A training ``spec`` may name a ``train_config`` and
    ``num_microbatches``.  Returns the step's ``CostCounter`` summary
    (``counts``), the per-rank ``memory`` record, the run's settings
    (``run``) and the world (``chips``); raises what the step raises."""
    world = spec.get("world") or (512 if multi_pod else 256)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        if "world" in spec:
            mesh = mesh_lib.make_local_mesh(spec.get("model_axis", 1),
                                            device=dev)
        else:
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                 device=dev)
        model = LanguageModel(cfg)
        with FakeTensorMode(allow_non_fake_inputs=True), \
                _one_resampling_round(), warnings.catch_warnings(), \
                cost_analysis.sharding_propagation_unseen():
            # c10d's deprecation warning on every gather: most of the
            # collectives' host time here
            warnings.simplefilter("ignore", FutureWarning)
            if spec["kind"] == "train":
                got = _train_cell(model, cfg, mesh, rules, spec, dev)
            elif spec["kind"] == "prefill":
                got = _prefill_cell(model, cfg, mesh, rules, spec, dev)
            else:
                got = _decode_cell(model, cfg, mesh, rules, spec, dev,
                                   page_size, num_pages)
    finally:
        dist.destroy_process_group()
    counter, args_bytes, peak, out_bytes, init_peak, run = got
    return {"counts": counter, "chips": world, "device": str(dev),
            "memory": _memory_record(args_bytes, peak, out_bytes, init_peak),
            "run": run}


def lower_cell(arch: str, shape: str, multi_pod: bool = False,
               fsdp: bool = True, sp: Optional[bool] = None,
               mach: str = "auto", page_size: int = 0, num_pages: int = 0,
               spec: Optional[dict] = None, device="cpu",
               top_bytes: int = 0, cfg_updates: Optional[dict] = None,
               mach_pod_parallel: bool = False) -> CellResult:
    """One cell's dry run in this process (``dry_step``) and its record:
    flops, bytes and collectives per rank, the roofline on the H100
    constants, the memory record, the config.  ``spec`` replaces
    ``SHAPES[shape]`` (``dry_step``); ``cfg_updates`` replaces fields of
    the model config.  A failure of the step (a refusal, an error) comes
    back as ``ok=False`` with its message in ``reason``."""
    cfg = get_config(arch, mach=mach)
    if cfg_updates:
        cfg = dataclasses.replace(cfg, **cfg_updates)
    if spec is None:
        ok, reason = shape_applicable(cfg, shape)
        if not ok:
            return CellResult(arch, shape, mesh_name({}, multi_pod), ok=True,
                              skipped=True, reason=reason)
        spec = SHAPES[shape]
    name, kind = mesh_name(spec, multi_pod), spec["kind"]
    # serving gathers the params whole (launch/serve.py); SP regressed
    # collectives 11x in the JAX package and is off unless asked for
    rules = ShardingRules(fsdp=fsdp if kind == "train" else False,
                          sp=bool(sp), mach_pod_parallel=mach_pod_parallel)
    t0 = time.time()
    try:
        got = dry_step(cfg, spec, rules, multi_pod=multi_pod, device=device,
                       page_size=page_size, num_pages=num_pages)
    except Exception as e:                  # noqa: BLE001 — a failed cell
        return CellResult(arch, shape, name, ok=False,
                          reason=f"{type(e).__name__}: {e}",
                          seconds=time.time() - t0)
    res = got["counts"].summary(top_bytes)
    n_chips = got["chips"]
    flops_dev, bytes_dev = float(res["flops"]), float(res["bytes"])
    compute_s = flops_dev / mesh_lib.PEAK_FLOPS_BF16
    memory_s = bytes_dev / mesh_lib.HBM_BW
    coll_s = res["collective_wire_bytes"] / mesh_lib.NVLINK_BW
    useful = model_flops(cfg, spec)
    data = {
        "arch": arch, "shape": shape, "mesh": name, "kind": kind,
        "chips": n_chips, "device": got["device"],
        "memory": got["memory"],
        "cost": {
            "flops_per_device": flops_dev,
            "flops_global": flops_dev * n_chips,
            "bytes_accessed_per_device": bytes_dev,
            "transcendentals_per_device": float(res["transcendentals"]),
        },
        "collectives": res["collectives"],
        "kernels": res["kernels"],
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": coll_s,
            "bottleneck": max(
                (("compute", compute_s), ("memory", memory_s),
                 ("collective", coll_s)), key=lambda kv: kv[1])[0],
            "model_flops": useful,
            "useful_flops_fraction": (useful / (flops_dev * n_chips)
                                      if flops_dev else 0.0),
        },
        "config": {
            "params_analytic": cfg.param_count_estimate(),
            "params_active": _active_params(cfg),
            "fsdp": rules.fsdp, "sp": rules.sp,
            "mach": (dataclasses.asdict(cfg.mach) if cfg.mach else None),
            "seq_len": spec["seq_len"], "global_batch": spec["global_batch"],
            **got["run"],
        },
        "constants": "H100 data sheet (launch/mesh.py): arithmetic, not a "
                     "measurement",
    }
    if kind != "train":
        data["serve_split"] = False     # every rank serves the whole batch
    if top_bytes:
        data["top_bytes"] = res["top_bytes"]
    return CellResult(arch, shape, name, ok=True, seconds=time.time() - t0,
                      data=data)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _artifact(mesh_name: str, arch: str, shape: str) -> str:
    return os.path.join(ARTIFACT_DIR, mesh_name, f"{arch}__{shape}.json")


def run_one(args) -> int:
    res = lower_cell(args.arch, args.shape, args.multi_pod,
                     fsdp=not args.no_fsdp,
                     sp=None if args.sp == "auto" else args.sp == "on",
                     mach=args.mach, page_size=args.page_size,
                     num_pages=args.num_pages)
    out = _artifact(res.mesh, args.arch, args.shape)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(dataclasses.asdict(res), f, indent=1)
    if res.skipped:
        print(f"SKIP {args.arch} × {args.shape} [{res.mesh}]: {res.reason}")
        return 0
    if not res.ok:
        print(f"FAIL {args.arch} × {args.shape} [{res.mesh}]: {res.reason}")
        return 1
    rf = res.data["roofline"]
    mem = res.data["memory"]
    gib = 2 ** 30
    print(f"OK {args.arch} × {args.shape} [{res.mesh}] {res.seconds:.0f}s  "
          f"peak/dev={mem['per_device_peak_bytes'] / gib:.2f}GiB "
          f"init={mem['init_peak_bytes'] / gib:.2f}GiB "
          f"fits={mem['fits_hbm']}  "
          f"compute={rf['compute_s'] * 1e3:.2f}ms "
          f"memory={rf['memory_s'] * 1e3:.2f}ms "
          f"coll={rf['collective_s'] * 1e3:.2f}ms -> {rf['bottleneck']} "
          f"(H100 data-sheet arithmetic)")
    print(json.dumps({"memory": mem, "cost": res.data["cost"],
                      "roofline": rf}, indent=1))
    return 0


def run_all(args) -> int:
    """Spawn one subprocess per cell (a fake world of its own each; a
    failed cell does not stop the sweep)."""
    fails = []
    meshes = [False, True] if args.mesh == "both" else \
        [args.mesh == "multi"]
    for multi in meshes:
        for arch in (args.archs or ARCH_IDS):
            for shape in (args.shapes or SHAPES):
                mesh_name = "pod2x16x16" if multi else "pod16x16"
                out = _artifact(mesh_name, arch, shape)
                if args.resume and os.path.exists(out):
                    with open(out) as f:
                        if json.load(f).get("ok"):
                            continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape]
                if multi:
                    cmd.append("--multi-pod")
                if args.no_fsdp:
                    cmd.append("--no-fsdp")
                t0 = time.time()
                try:
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=CELL_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    print(f"[{time.strftime('%H:%M:%S')}] {mesh_name} "
                          f"{arch} × {shape}: still running after "
                          f"{CELL_TIMEOUT_S} s (killed)", flush=True)
                    fails.append((mesh_name, arch, shape))
                    continue
                tail = (r.stdout.strip().splitlines() or [""])[0]
                print(f"[{time.strftime('%H:%M:%S')}] {mesh_name} {arch} × "
                      f"{shape}: rc={r.returncode} ({time.time()-t0:.0f}s) "
                      f"{tail[:160]}", flush=True)
                if r.returncode != 0:
                    fails.append((mesh_name, arch, shape))
                    err = (r.stderr or "").strip().splitlines()
                    print("   " + "\n   ".join(err[-6:]), flush=True)
    print(f"\n{'ALL CELLS PASS' if not fails else f'{len(fails)} FAILURES'}")
    for f3 in fails:
        print("  FAIL:", *f3)
    return 1 if fails else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="production-mesh dry run")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true", dest="multi_pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--shapes", nargs="*", default=None)
    ap.add_argument("--no-fsdp", action="store_true", dest="no_fsdp")
    ap.add_argument("--sp", choices=("auto", "on", "off"), default="auto")
    ap.add_argument("--mach", choices=("auto", "on", "off"), default="auto")
    ap.add_argument("--page-size", type=int, default=0, dest="page_size",
                    help="decode cells: paged KV pool page size "
                         "(0: contiguous strips)")
    ap.add_argument("--num-pages", type=int, default=0, dest="num_pages",
                    help="decode cells: KV pool pages (0: derive "
                         "batch * ceil(seq_len / page_size))")
    args = ap.parse_args(argv)
    if args.all:
        return run_all(args)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    try:
        return run_one(args)
    except Exception:                       # noqa: BLE001 — report, exit 1
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())

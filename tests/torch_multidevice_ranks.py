"""The rank side of ``test_torch_multidevice.py``: CPU ``gloo`` worlds of
2 and 4 processes that train, checkpoint and serve through the port's
mesh paths beside the single-device port, and write what they measured
for the test process to hold.  No JAX here: each rank imports only
torch and the port.

``GatherCount`` and ``gather_bounds`` (the bytes a sharded step holds
gathered, and their bound) serve the card's tests and ``chip_smoke.py``
too.

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
import weakref

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
    """The smoke config of ``arch`` in float32 (params and activations),
    with ``remat="full"`` (the full configs' default: the sharded step's
    gathers run inside each recomputed period) and at least 4 layers (so
    two periods are below the whole stack)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, dtype=torch.float32, remat="full",
                               num_layers=max(4, cfg.num_layers),
                               **overrides)


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


class GatherCount:
    """Within the block, ``partitioning.materialize`` (which the model
    calls by its module attribute) counts the bytes of the whole tensors
    it makes of ``DTensor`` leaves that are alive at once.  A whole
    tensor in new memory (a world of 2 or more) counts until its storage
    is freed, wherever autograd keeps it; one that aliases its shard (a
    world of one, where gathering moves nothing, or a shard kept by a
    split use) counts until its Python object dies, so it measures the
    schedule, not new bytes.  ``peak`` is the most at once, ``calls`` the
    gathered leaves, ``bytes`` all their bytes."""

    def __init__(self):
        self.alive = self.peak = self.calls = self.bytes = 0

    def __enter__(self):
        from repro_torch.sharding import partitioning
        self._module, self._wrapped = partitioning, partitioning.materialize
        partitioning.materialize = self._counted
        return self

    def __exit__(self, *exc):
        self._module.materialize = self._wrapped
        return False

    def _free(self, n):
        self.alive -= n

    def _counted(self, tree, *args, **kw):
        from torch.distributed.tensor import DTensor

        from repro_torch.checkpoint import tree_flatten
        out = self._wrapped(tree, *args, **kw)
        for (_, x), (_, whole) in zip(tree_flatten(tree), tree_flatten(out)):
            if isinstance(x, DTensor):
                n = whole.numel() * whole.element_size()
                storage = whole.untyped_storage()
                shard = x.to_local().untyped_storage()
                owner = whole if storage.data_ptr() == shard.data_ptr() \
                    else storage
                self.alive += n
                self.calls += 1
                self.bytes += n
                self.peak = max(self.peak, self.alive)
                weakref.finalize(owner, self._free, n)
        return out


def gather_bounds(params) -> dict:
    """Whole bytes of a params tree: ``whole`` (every leaf), ``bound``
    (the leaves outside the layer stacks plus two of the largest
    period)."""
    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in _tensor_leaves(tree))

    stacked = [k for k in ("stacks", "enc_stacks") if k in params]
    period = max(nbytes(p_list) // _tensor_leaves(p_list)[0].shape[0]
                 for k in stacked for p_list in params[k])
    rest = nbytes({k: v for k, v in params.items() if k not in stacked})
    return {"whole": nbytes(params), "bound": rest + 2 * period,
            "period": period, "rest": rest}


def sharded_vs_one_device(model_cfg, tcfg, mesh, steps_batches, rules=None,
                          watch=None):
    """The same steps through ``Trainer(mesh=)`` and the single-device
    ``Trainer`` from one seed: per step both metrics dicts, then the
    gathered final params and the single device's; ``gathered``: the
    sharded steps' ``GatherCount`` peak beside ``gather_bounds``.
    ``watch``: a pair of context managers around each sharded and each
    single-device step (``HeadCount``s)."""
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import gather
    from repro_torch.train import Trainer
    model = LanguageModel(model_cfg)
    sharded = Trainer(model, tcfg, mesh=mesh, rules=rules)
    single = Trainer(model, tcfg)
    gen = lambda: torch.Generator().manual_seed(0)   # noqa: E731
    st, rs = sharded.init_state(gen(), "cpu"), single.init_state(gen(), "cpu")
    metrics, count = [], GatherCount()
    on_mesh, on_one = watch or (contextlib.nullcontext(),
                                contextlib.nullcontext())
    for b in steps_batches:
        with count, on_mesh:
            st, m = sharded.step_fn(st, b)
        with on_one:
            rs, rm = single.step_fn(rs, b)
        metrics.append((_metrics(m), _metrics(rm)))
    return {"metrics": metrics, "params": gather(st.params),
            "want": rs.params, "state": st,
            "gathered": dict(gather_bounds(rs.params), peak=count.peak,
                             calls=count.calls)}


class HeadCount:
    """Within the block, what a step does with the MACH head: the rank's
    ``partitioning.head_split`` (its repetitions and the mesh axes kept
    by the head's gather), the shape and bytes of every gathered head
    kernel (``partitioning.materialize`` of a tree whose ``kernel`` is
    (d, ·)), the repetitions each ``ops.mach_xent`` (the logits' R) and
    ``ops.mach_fused_xent`` call (the labels' R) sees, each
    ``ops.mach_select_buckets`` call's proxy, labels and selection, and
    each ``ops.mach_bucket_proxy`` call's rows, depth and scale.  The
    model and ``ops`` call all six by their module attributes."""

    def __init__(self, d_model: int):
        self.d_model = d_model
        self.splits, self.gathers, self.xent, self.fused = [], [], [], []
        self.selections, self.proxies = [], []

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.sharding import partitioning
        self._saved = [(partitioning, "head_split"),
                       (partitioning, "materialize"), (ops, "mach_xent"),
                       (ops, "mach_fused_xent"), (ops, "mach_select_buckets"),
                       (ops, "mach_bucket_proxy")]
        self._saved = [(m, n, getattr(m, n)) for m, n in self._saved]
        (_, _, split), (_, _, mat), (_, _, xent), (_, _, fused), \
            (_, _, select), (_, _, proxy_fn) = self._saved

        def head_split(leaf, r):
            out = split(leaf, r)
            if out is not None:
                names = out.mesh.mesh_dim_names
                self.splits.append((out.r0, out.r1,
                                    tuple(names[i] for i in out.dims)))
            return out

        def materialize(tree, *args, **kw):
            out = mat(tree, *args, **kw)
            if isinstance(out, dict) and set(out) == {"kernel"} and \
                    out["kernel"].shape[0] == self.d_model:
                k = out["kernel"]
                self.gathers.append((tuple(k.shape),
                                     k.numel() * k.element_size()))
            return out

        def mach_xent(logits, hashed, *args, **kw):
            self.xent.append(logits.shape[-2])
            return xent(logits, hashed, *args, **kw)

        def mach_fused_xent(h, w, hashed, *args, **kw):
            self.fused.append(hashed.shape[-1])
            return fused(h, w, hashed, *args, **kw)

        def mach_select_buckets(proxy, hashed, *args, **kw):
            out = select(proxy, hashed, *args, **kw)
            self.selections.append((proxy.clone(), hashed.clone(),
                                    out.clone()))
            return out

        def mach_bucket_proxy(h, w, *args, **kw):
            # the largest (mean |h|) @ |W|: the scale of the proxy's
            # float32 rounding, beside the rows and depth it sums over
            h2 = h.detach().reshape(-1, h.shape[-1]).float()
            scale = h2.abs().mean(dim=0) @ w.detach().float().abs()
            self.proxies.append((h2.shape[0], h2.shape[1],
                                 float(scale.max())))
            return proxy_fn(h, w, *args, **kw)

        for (m, n, _), fn in zip(self._saved, (head_split, materialize,
                                               mach_xent, mach_fused_xent,
                                               mach_select_buckets,
                                               mach_bucket_proxy)):
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self._saved:
            setattr(m, n, fn)
        return False

    def summary(self) -> dict:
        return {"splits": self.splits, "gathers": self.gathers,
                "xent": self.xent, "fused": self.fused,
                "selected": [sel for _, _, sel in self.selections]}


class SplitCount:
    """Within the block, what a sharded step does with its decoder: for
    every period ``transformer.materialize_period`` gathers, each block's
    split it is handed (the attention's query heads [r0, r1) and mesh axes, the kv
    heads it cuts from the whole k and v, the MLP's columns and axes;
    None where the block runs whole), the local shape of every leaf it
    hands the block, and the bytes the period's gathers made (a
    ``GatherCount`` around the call); the query and kv heads of every
    ``attention.attend`` call and the hidden columns of every
    ``layers.apply_mlp`` call.  For MoE blocks, per period each block's
    ``MoESplit`` (``moe``: the mode, its range and axes, the shared
    MLP's columns and axes), the expert kernel and expert input shapes
    of every ``moe._expert_ffn`` call, and the expert ids and kept mask
    of every ``moe.route`` call.  Per period each block's RG-LRU channels
    and axes (``rglru``) and cross-attention query heads, axes and cut kv
    heads (``xattn``), None where they run whole or the block has none;
    the channels of every ``ops.lru_scan`` call (``scan``) and the kv
    heads of every ``cross_kv`` call (``cross_kv``).  The model calls
    all seven by their module attributes (``cross_kv`` by the model
    module's)."""

    def __init__(self):
        self.periods, self.attend, self.mlp = [], [], []
        self.moe, self.experts, self.routing = [], [], []
        self.rglru, self.xattn, self.scan, self.cross_kv = [], [], [], []

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import attention, layers, model, moe
        from repro_torch.models import transformer
        self._count = GatherCount().__enter__()
        self._saved = [(m, n, getattr(m, n)) for m, n in (
            (transformer, "materialize_period"), (attention, "attend"),
            (layers, "apply_mlp"), (moe, "_expert_ffn"), (moe, "route"),
            (ops, "lru_scan"), (model, "cross_kv"))]
        (_, _, period_fn), (_, _, attend), (_, _, mlp), (_, _, ffn), \
            (_, _, route), (_, _, scan), (_, _, cross) = self._saved

        def materialize_period(layer_params, splits):
            before = self._count.bytes
            params = period_fn(layer_params, splits)
            self.periods.append((
                tuple(_split_summary(s) for s in splits),
                [_shapes(p) for p in params], self._count.bytes - before))
            self.moe.append(tuple(_moe_summary(s) for s in splits))
            self.rglru.append(tuple(None if s is None else _range(s.rglru)
                                    for s in splits))
            self.xattn.append(tuple(
                None if s is None or s.xattn is None
                else (_range(s.xattn), s.xkv) for s in splits))
            return params

        def counted_attend(q, k, *args, **kw):
            self.attend.append((q.shape[2], k.shape[2]))
            return attend(q, k, *args, **kw)

        def apply_mlp(params, x, *args, **kw):
            self.mlp.append(params["wi"]["kernel"].shape[-1])
            return mlp(params, x, *args, **kw)

        def expert_ffn(params, xe, *args, **kw):
            self.experts.append((tuple(params["wi"]["kernel"].shape),
                                 tuple(xe.shape)))
            return ffn(params, xe, *args, **kw)

        def counted_route(*args, **kw):
            r = route(*args, **kw)
            self.routing.append((r.experts.clone(), r.keep.clone()))
            return r

        def lru_scan(a, x, *args, **kw):
            self.scan.append(x.shape[-1])
            return scan(a, x, *args, **kw)

        def cross_kv(*args, **kw):
            k, v = cross(*args, **kw)
            self.cross_kv.append(k.shape[2])
            return k, v

        for (m, n, _), fn in zip(self._saved, (materialize_period,
                                               counted_attend, apply_mlp,
                                               expert_ffn, counted_route,
                                               lru_scan, cross_kv)):
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self._saved:
            setattr(m, n, fn)
        self._count.__exit__(*exc)
        return False

    def summary(self) -> dict:
        return {"periods": self.periods, "attend": sorted(set(self.attend)),
                "mlp": sorted(set(self.mlp)), "moe": self.moe,
                "experts": sorted(set(self.experts)),
                "routing": self.routing, "rglru": self.rglru,
                "xattn": self.xattn, "scan": sorted(set(self.scan)),
                "cross_kv": sorted(set(self.cross_kv))}


def _range(s):
    return None if s is None else (
        s.r0, s.r1, tuple(s.mesh.mesh_dim_names[i] for i in s.dims))


def _split_summary(split):
    if split is None:
        return None
    return _range(split.attn), split.kv, _range(split.mlp)


def _moe_summary(split):
    """A block's ``MoESplit`` as (mode, the routed range, the shared
    MLP's range), None where the block has none."""
    if split is None or split.moe is None:
        return None
    m = split.moe
    mode = "experts" if m.experts is not None else (
        "columns" if m.columns is not None else None)
    return mode, _range(m.routed), _range(m.shared)


class GradCapture:
    """Within the block, the first gradients a train step clips
    (``trainer.clip_by_global_norm``'s argument, which the step calls
    by its module attribute), made whole (``gather``: under a mesh a
    collective every rank's step calls) and copied: ``first``."""

    def __init__(self):
        self.first = None

    def __enter__(self):
        from repro_torch.checkpoint import tree_flatten, tree_unflatten
        from repro_torch.sharding import gather
        from repro_torch.train import trainer
        self._module, self._clip = trainer, trainer.clip_by_global_norm

        def clip(grads, *args, **kw):
            if self.first is None:
                whole = gather(grads)
                self.first = tree_unflatten(whole, [
                    x.detach().clone() for _, x in tree_flatten(whole)])
            return self._clip(grads, *args, **kw)

        trainer.clip_by_global_norm = clip
        return self

    def __exit__(self, *exc):
        self._module.clip_by_global_norm = self._clip
        return False


def moe_rank_block(params, mode, n, rank, mesh=None, dims=(), batch=()):
    """An MoE block's params (``moe.init_moe``'s tree) as rank ``rank``
    of n holds them where its experts split by ``mode`` ("experts": EP,
    the rank's experts [k·E/n, (k+1)·E/n); "columns": expert TP, every
    expert's hidden columns [k·F/n, (k+1)·F/n)) and its shared MLP by
    columns: (the rank's params, the ``MoESplit`` over the mesh dims
    ``dims`` of ``mesh``, the step's rows over ``batch``).  The router
    and ``shared_gate`` stay whole.  With no dims, or on a world-1 mesh,
    ``into`` and ``out_of`` are the identity: ``apply_moe(split=)`` then
    returns the rank's partial output."""
    from repro_torch.sharding import MoESplit, RangeSplit

    def ranks(size):
        return rank * size // n, (rank + 1) * size // n

    def cut(leaf, *idx):
        return {"kernel": leaf["kernel"][idx].contiguous()}

    wi = params["wi"]["kernel"]
    r0, r1 = ranks(wi.shape[0] if mode == "experts" else wi.shape[-1])
    local = dict(params)
    for key in ("wi", "wg", "wo"):
        if key in params:
            local[key] = cut(params[key], slice(r0, r1)) \
                if mode == "experts" else \
                cut(params[key], slice(None), slice(r0, r1)) \
                if key == "wo" else cut(params[key], ..., slice(r0, r1))
    routed = RangeSplit(mesh, r0, r1, dims, batch)
    shared = None
    if "shared" in params:
        s0, s1 = ranks(params["shared"]["wo"]["kernel"].shape[0])
        local["shared"] = {
            key: cut(leaf, slice(s0, s1)) if key == "wo"
            else cut(leaf, slice(None), slice(s0, s1))
            for key, leaf in params["shared"].items()}
        shared = RangeSplit(mesh, s0, s1, dims, batch)
    return local, MoESplit(routed if mode == "experts" else None,
                           routed if mode == "columns" else None, shared)


def rglru_channels(params, c0, c1):
    """An RG-LRU block's params (``recurrent.init_rglru_block``'s tree)
    as a rank of its split by channels holds them: channels [c0, c1) of
    every leaf — lin_y's and lin_x's columns, the conv's and Λ's
    entries, the rows of gate_a, gate_x and lin_out."""
    c = slice(c0, c1)
    return {"lin_y": {"kernel": params["lin_y"]["kernel"][:, c].contiguous()},
            "lin_x": {"kernel": params["lin_x"]["kernel"][:, c].contiguous()},
            "conv": {"w": params["conv"]["w"][:, c].contiguous(),
                     "b": params["conv"]["b"][c].contiguous()},
            "lam": {"log": params["lam"]["log"][c].contiguous()},
            **{key: {"kernel": params[key]["kernel"][c].contiguous()}
               for key in ("gate_a", "gate_x", "lin_out")}}


def _shapes(tree):
    from repro_torch.checkpoint import tree_flatten
    return {path: tuple(x.shape) for path, x in tree_flatten(tree)}


def split_case(model_cfg, mesh, data, tcfg=None, rules=None,
               grads=False) -> dict:
    """``sharded_vs_one_device`` with a ``SplitCount`` around the sharded
    steps: ``split`` holds every rank's count (gathered to each rank)
    with its mesh coordinate, ``shape`` the mesh's axis sizes; with
    ``grads``, ``grads`` and ``want_grads`` the first step's gradients,
    sharded (made whole) and on one device (``GradCapture``)."""
    count = on_mesh = SplitCount()
    on_one = contextlib.nullcontext()
    if grads:
        captured, on_one = GradCapture(), GradCapture()
        on_mesh = _Nested(count, captured)
    full = sharded_vs_one_device(model_cfg, tcfg or train_config(), mesh,
                                 data, rules, (on_mesh, on_one))
    res = _strip(full)
    if grads:
        res["grads"], res["want_grads"] = captured.first, on_one.first
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, dict(count.summary(),
                                       coord=tuple(mesh.get_coordinate())))
    res["split"] = ranks
    res["shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return res


class _Nested:
    """Context managers entered in order as one, and left in reverse."""

    def __init__(self, *managers):
        self.managers = managers

    def __enter__(self):
        for m in self.managers:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self.managers):
            m.__exit__(*exc)
        return False


def mach_model_config(num_repetitions=4, **overrides):
    """The smoke tinyllama-1.1b (``model_config``) with a MACH head of
    R x 16 buckets over its 256 tokens."""
    from repro_torch.configs import default_mach_head
    return model_config("tinyllama-1.1b", mach=default_mach_head(
        256, "on", num_buckets=16, num_repetitions=num_repetitions),
        **overrides)


def head_split_case(model_cfg, mesh, data, rules=None) -> dict:
    """``sharded_vs_one_device`` with a ``HeadCount`` around both steps
    and a ``SplitCount`` around the sharded ones: ``head`` holds every
    rank's sharded head count (gathered to each rank, with its mesh
    coordinate and ``repetition_range`` of its head leaf), ``split`` its
    decoder count (``split_case``), ``one`` the single device's
    selections with their proxies and labels, ``one_proxies`` its
    proxies' sizes."""
    from repro_torch.sharding import repetition_range
    on_mesh, on_one, decoder = (HeadCount(model_cfg.d_model),
                                HeadCount(model_cfg.d_model), SplitCount())
    full = sharded_vs_one_device(model_cfg, train_config(), mesh, data,
                                 rules, (_Nested(on_mesh, decoder), on_one))
    res = _strip(full)
    reps = repetition_range(full["state"].params["mach_head"]["kernel"],
                            model_cfg.mach.num_repetitions)
    coord = tuple(mesh.get_coordinate())
    res["head"] = [None] * dist.get_world_size()
    dist.all_gather_object(res["head"], dict(on_mesh.summary(), range=reps,
                                             coord=coord))
    res["split"] = [None] * dist.get_world_size()
    dist.all_gather_object(res["split"], dict(decoder.summary(),
                                              coord=coord))
    res["one"] = on_one.selections
    res["one_proxies"] = on_one.proxies
    res["shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return res


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
    loss, a bf16 run, checkpoints, a restart, the entry points; (1, 2):
    the MACH head, the decoder split and the MoE experts split."""
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
    out["adamw"] = _strip(adamw)
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
    for case, arch in (("xlstm", "xlstm-350m"),
                       ("encdec", "seamless-m4t-large-v2"),
                       ("vision", "paligemma-3b")):
        cfg = model_config(arch)
        out[case] = _strip(sharded_vs_one_device(cfg, train_config(), mesh,
                                                 batches(cfg, 2)))
    bf16 = dataclasses.replace(tiny, dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
    out["bf16"] = _strip(sharded_vs_one_device(bf16, train_config(), mesh,
                                               batches(bf16, 2)))
    out.update(head_split_world2())
    out.update(decoder_split_world2(tiny, bf16))
    qwen = model_config("qwen2-moe-a2.7b")
    # (1, 2): 3 of qwen2-moe's 6 experts a rank (EP), its shared MLP and
    # attention split too
    out["moe12"] = split_case(qwen, _mesh((1, 2)), batches(qwen, 2),
                              grads=True)
    out["mesh_view"] = resolve_spec(
        mesh, ShardingRules().table(mesh), ("embed", "mlp"), (64, 128))
    out["init"] = {
        "adamw": init_matches_placing_all(tiny, train_config(), mesh),
        "master": init_matches_placing_all(
            bf16, train_config(master_weights=True), mesh),
        "adafactor": init_matches_placing_all(
            tiny, train_config(optimizer="adafactor"), mesh)}
    out["collectives"] = step_collectives(tiny, mesh)
    out["unstack"] = unstack_collectives(tiny, mesh)

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


def head_split_world2() -> dict:
    """Mesh (1, 2): the MACH head split by repetition (R = 4), unfused
    and fused; R = 3, which 2 does not divide (the gathered head); the
    in-loss bucket selection (c_sel = 12 of 16 on 4-token rows, so the
    label buckets do not fill every selection); the decoder split by
    heads and hidden with each."""
    m12 = _mesh((1, 2))
    split, r3 = mach_model_config(), mach_model_config(3)
    sel = mach_model_config(mach_fused_loss=True,
                            mach_bucket_select=(12, 1))
    return {
        "split12": head_split_case(split, m12, batches(split, 2)),
        "split12_fused": head_split_case(
            dataclasses.replace(split, mach_fused_loss=True), m12,
            batches(split, 2)),
        "r3": head_split_case(r3, m12, batches(r3, 2)),
        "select12": head_split_case(sel, m12, batches(sel, 2, seq=4))}


def decoder_split_world2(tiny, bf16) -> dict:
    """Mesh (1, 2): the decoder split by heads and hidden — the smoke
    tinyllama (k and v split with q), its bf16 run, recurrentgemma-2b
    (H = 2, KV = 1: the attention split, k and v cut from the whole, the
    MLP split, the RG-LRU on 32 of its 64 channels) and
    seamless-m4t-large-v2 (the encoder's and decoder's self-attention,
    the cross-attention and its K/V on 2 of 4 heads)."""
    m12 = _mesh((1, 2))
    rg = model_config("recurrentgemma-2b")
    seamless = model_config("seamless-m4t-large-v2")
    return {"tp12": split_case(tiny, m12, batches(tiny, 2)),
            "tp12_bf16": split_case(bf16, m12, batches(bf16, 2)),
            "tp12_rg": split_case(rg, m12, batches(rg, 2), grads=True),
            "tp12_seamless": split_case(seamless, m12, batches(seamless, 2),
                                        grads=True)}


# the decoder split on (1, 4) beyond tinyllama: case -> arch
DECODER_WORLD4 = {"tp14_rg": "recurrentgemma-2b",
                  "tp14_seamless": "seamless-m4t-large-v2",
                  "tp14_paligemma": "paligemma-3b",
                  "tp14_granite": "granite-20b",
                  "tp14_phi3": "phi3-mini-3.8b",
                  "tp14_mistral": "mistral-large-123b"}


def world4_split(rank, directory):
    """Mesh (1, 4), a world of its own (each world has its deadline):
    recurrentgemma-2b (its RG-LRU on 16 of 64 channels, its MLP split,
    its 2 heads whole), seamless-m4t-large-v2 (one of 4 heads a rank in
    every attention, the cross K/V with them), paligemma-3b and
    granite-20b (KV = 1: one query head a rank, the kv head cut from the
    whole), phi3-mini (k and v split with q) and mistral-large-123b (6
    heads whole, the MLP split)."""
    m14 = _mesh((1, 4))
    out = {}
    for case, arch in DECODER_WORLD4.items():
        cfg = model_config(arch)
        out[case] = split_case(cfg, m14, batches(cfg, 2), grads=True)
    out["counted_step"] = counted_step(mach_model_config(), m14)
    return out


def counted_step(model_cfg, mesh) -> dict:
    """One step of ``Trainer(mesh=)`` (the FSDP rules, ``train_config()``)
    on ``batches(model_cfg, 1)`` under a ``CostCounter``, as
    ``launch/dryrun.py`` runs a training cell on fake tensors: this
    rank's counts and the bytes of its placed local state and batch."""
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.dryrun import _storage_bytes
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import ShardingRules, activate
    from repro_torch.train import Trainer
    rules = ShardingRules()
    trainer = Trainer(LanguageModel(model_cfg), train_config(), mesh=mesh,
                      rules=rules)
    state = trainer.init_state(torch.Generator().manual_seed(0), "cpu")
    batch = batches(model_cfg, 1)[0]
    with activate(mesh, rules), CostCounter() as counter:
        trainer.step_fn(state, batch)
    return {"counts": counter.summary(), "state_bytes": _storage_bytes(state),
            "batch_bytes": _storage_bytes(batch)}


def head_split_world4() -> dict:
    """Meshes (2, 2) and (1, 4) with the MACH head split by repetition,
    unfused and fused; (2, 1, 2) with ``mach_pod_parallel`` (the head
    over (pod, model)); the in-loss bucket selection on (2, 2)."""
    from repro_torch.sharding import ShardingRules
    split = mach_model_config()
    fused = dataclasses.replace(split, mach_fused_loss=True)
    sel = mach_model_config(mach_fused_loss=True,
                            mach_bucket_select=(12, 1))
    m22, m14 = _mesh((2, 2)), _mesh((1, 4))
    pod = _mesh((2, 1, 2), ("pod", "data", "model"))
    pod_rules = ShardingRules(mach_pod_parallel=True)
    out = {}
    for name, mesh, rules in (("split22", m22, None), ("split14", m14, None),
                              ("pod_split", pod, pod_rules)):
        out[name] = head_split_case(split, mesh, batches(split, 2), rules)
        out[name + "_fused"] = head_split_case(fused, mesh,
                                               batches(fused, 2), rules)
    out["select22"] = head_split_case(sel, m22, batches(sel, 2, seq=4))
    return out


def moe_split_world4(m22) -> dict:
    """The MoE experts split on ``model``: qwen2-moe on (1, 4), where 4
    does not divide its 6 experts, by 12 of every expert's 48 columns
    (expert TP); mixtral on (1, 4) by one of its 4 experts a rank (EP),
    its attention cutting a kv head from the whole k and v; qwen2-moe
    on (2, 2), FSDP on ``data`` and 3 experts a rank on ``model``."""
    qwen, mix = model_config("qwen2-moe-a2.7b"), model_config("mixtral-8x22b")
    m14 = _mesh((1, 4))
    return {"moe14": split_case(qwen, m14, batches(qwen, 2), grads=True),
            "moe14_mixtral": split_case(mix, m14, batches(mix, 2),
                                        grads=True),
            "moe22": split_case(qwen, m22, batches(qwen, 2), grads=True)}


def _strip(res):
    return {k: res[k] for k in ("metrics", "params", "want", "gathered")}


def init_matches_placing_all(model_cfg, tcfg, mesh) -> list:
    """``Trainer.init_state`` (params placed first, the optimizer state
    built on them) against placing a whole drawn state: per leaf, whether
    both are ``DTensor``s with equal placements and local shards."""
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import place
    from repro_torch.train import Trainer
    from repro_torch.train.train_state import new_train_state
    trainer = Trainer(LanguageModel(model_cfg), tcfg, mesh=mesh)
    gen = lambda: torch.Generator().manual_seed(3)   # noqa: E731
    got = trainer.init_state(gen(), "cpu")
    want = place(new_train_state(trainer.model.init(gen(), "cpu"),
                                 trainer.opt), trainer.state_shardings)
    same = []
    for g, w in zip(_tensor_leaves(got), _tensor_leaves(want)):
        same.append(type(g).__name__ == type(w).__name__ == "DTensor"
                    and g.placements == w.placements
                    and g.dtype == w.dtype
                    and torch.equal(g.to_local(), w.to_local()))
    return same


def unstack_collectives(model_cfg, mesh) -> dict:
    """``transformer.unstack`` of a placed stack (the layer dim
    replicated): the collectives it ran (``CommDebugMode``) and whether
    each slice is a ``DTensor`` on its leaf's placements less the layer
    dim."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import LanguageModel, transformer
    from repro_torch.train import Trainer
    trainer = Trainer(LanguageModel(model_cfg), train_config(), mesh=mesh)
    stack = trainer.init_state(torch.Generator().manual_seed(0),
                               "cpu").params["stacks"][0]
    n = _tensor_leaves(stack)[0].shape[0]
    with CommDebugMode() as comms:
        slices = transformer.unstack(stack, n)
    local = all(
        tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
              for p in leaf.placements) == tuple(s.placements)
        for layer in slices
        for leaf, s in zip(_tensor_leaves(stack), _tensor_leaves(layer)))
    return {"collectives": comms.get_total_counts(), "placements": local,
            "layers": len(slices)}


def step_collectives(model_cfg, mesh) -> dict:
    """Two sharded steps with ``partitioning.gather`` and
    ``DTensor.full_tensor`` watched: how often the whole-tree gather ran,
    and the shape of every tensor made whole by ``full_tensor``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import LanguageModel
    from repro_torch.sharding import partitioning
    from repro_torch.train import Trainer, trainer as trainer_mod
    trainer = Trainer(LanguageModel(model_cfg), train_config(), mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0), "cpu")
    seen = {"gather": 0, "full_tensor": []}
    gather, full_tensor = partitioning.gather, DTensor.full_tensor

    def counted_gather(tree):
        seen["gather"] += 1
        return gather(tree)

    def counted_full(self, *a, **kw):
        seen["full_tensor"].append(tuple(self.shape))
        return full_tensor(self, *a, **kw)

    patched = [(partitioning, "gather", counted_gather),
               (trainer_mod, "gather", counted_gather),
               (DTensor, "full_tensor", counted_full)]
    saved = [(obj, name, getattr(obj, name, None)) for obj, name, _ in patched]
    try:
        for obj, name, fn in patched:
            setattr(obj, name, fn)
        for b in batches(model_cfg, 2):
            state, _ = trainer.step_fn(state, b)
    finally:
        for obj, name, fn in saved:
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)
    return seen


def world4(rank, directory):
    """Meshes (4, 1), (2, 2) (the decoder split) and (2, 2, 1) with a pod
    axis; (1, 4) with the decoder split four ways; the MoE experts split
    on (1, 4) and (2, 2); the world-2
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
    # (2, 2): FSDP over data and the decoder split over model together
    out["mesh2x2"] = split_case(tiny, m22, data)
    # (1, 4): two ranks a kv head, each cutting it from the whole k and v
    out["tp14"] = split_case(tiny, _mesh((1, 4)), batches(tiny, 2))
    pod = _mesh((2, 2, 1), ("pod", "data", "model"))
    out["pod"] = _strip(sharded_vs_one_device(
        tiny, train_config(), pod, batches(tiny, 2, global_batch=8)))
    out["mesh4x1_microbatches"] = _strip(sharded_vs_one_device(
        tiny, train_config(num_microbatches=2), m41,
        batches(tiny, 2, global_batch=8, weighted=True, seed=5)))
    out["init"] = {"adamw": init_matches_placing_all(tiny, train_config(),
                                                     m22)}
    out.update(head_split_world4())
    out.update(moe_split_world4(m22))

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

    # materialize a dim over (pod, data): whole, and its gradient (rank r
    # weighs it by r + 1) summed over both axes onto the shards
    from repro_torch.sharding import activate, materialize
    xd = distribute_tensor(x, pd, placements(spec, pd),
                           src_data_rank=None).requires_grad_(True)
    with activate(pd, ShardingRules(), batch_axes=("pod", "data")):
        whole = materialize({"x": xd})["x"]
        grad, = torch.autograd.grad((whole * x * (rank + 1)).sum(), [xd])
    out["two_axes"] = {"whole": torch.equal(whole, x),
                       "placements": grad.placements == xd.placements,
                       "grad": torch.equal(grad.full_tensor(), x * 10)}
    return out


def _tensor_leaves(state):
    from repro_torch.checkpoint import tree_flatten
    return [x for _, x in tree_flatten(state) if isinstance(x, torch.Tensor)]


RANK_FNS = {"world2": world2, "world4": world4, "world4_split": world4_split}

"""Cost analysis of one eager step, per rank: the counterpart of the JAX
package's ``repro/launch/hlo_analysis.py``.

That module reads the roofline's inputs from a compiled HLO module.  The
port compiles nothing, so ``CostCounter`` counts a step as it runs, op
by op, on real tensors or on fake ones (``torch._subclasses``'
``FakeTensorMode``: shapes and no data, as ``launch/dryrun.py`` runs
rank 0 of a production mesh), and returns the keys of
``hlo_analysis.analyze``:

  flops            matrix products exactly (``FlopCounterMode``'s
                   formulas, 2·|out|·K), elementwise and reduction ops
                   ~|shape| (pointwise ops their output's elements,
                   reductions their input's), transcendentals apart
  bytes            each launch's operands plus its outputs.  In eager
                   PyTorch every aten op is a launch, where XLA counts
                   at its fusion boundaries, so the port's bytes are
                   those of its eager ops; a view moves nothing, an
                   allocation nothing, a copy its source and target
  collectives      by kind from the c10d ops (all-reduce, all-gather,
                   reduce-scatter, all-to-all, send / recv as
                   collective-permute): count, in / out bytes, wire
                   bytes = max(in, out); their bytes count in ``bytes``
  kernels          (beyond ``analyze``'s keys) each hand-written
                   kernel's calls and the ``work()`` of each, which its
                   wrapper records through ``kernels/counting.py`` in
                   place of the ops inside it (allocations, the plain
                   version on the CPU, the stand-in on fake tensors);
                   they count in ``flops`` and ``bytes``

No trip-count correction: an eager loop (layers, microbatches, a plain
version's tiles outside a wrapper) counts every iteration as it runs.
No counterpart of ``hoisted_f32_copy_bytes``: the f32 copies it finds
are an artifact of XLA's CPU backend.  The dense and ELL fused-xent
families on real CPU tensors differentiate their plain versions with
autograd, so their backward ops count one by one there.

``torch.distributed._tools.fake_collectives`` (a private torch module)
is imported here so that c10d ops run on fake tensors; only this module
and ``launch/dryrun.py`` import torch's private distributed tools.
``sharding_propagation_unseen`` hooks a private method of DTensor's
``ShardingPropagator``.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
import torch.distributed._tools.fake_collectives  # noqa: F401  (see above)
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import counting

aten = torch.ops.aten
c10d = torch.ops.c10d
funcol = torch.ops._c10d_functional

def _ops(namespace, names: str) -> list:
    """The ops of ``namespace`` named in ``names`` that this torch has."""
    return [getattr(namespace, n) for n in names.split()
            if hasattr(namespace, n)]


# c10d op -> kind; inputs and outputs are read off the op's schema
_COLLECTIVE_OPS = {
    op: kind for kind, ops in (
        ("all-reduce", _ops(c10d, "allreduce_ allreduce_coalesced_")
         + _ops(funcol, "all_reduce all_reduce_ all_reduce_coalesced")),
        ("all-gather", _ops(c10d, "_allgather_base_ allgather_ "
                                  "allgather_into_tensor_coalesced_")
         + _ops(funcol, "all_gather_into_tensor "
                        "all_gather_into_tensor_out")),
        ("reduce-scatter", _ops(c10d, "_reduce_scatter_base_ reduce_scatter_ "
                                      "reduce_scatter_tensor_coalesced_")
         + _ops(funcol, "reduce_scatter_tensor")),
        ("all-to-all", _ops(c10d, "alltoall_base_ alltoall_")
         + _ops(funcol, "all_to_all_single")),
        ("collective-permute", _ops(c10d, "send recv_")),
        ("broadcast", _ops(c10d, "broadcast_") + _ops(funcol, "broadcast")))
    for op in ops}
# ops that move no bytes: allocations, a collective's wait and its
# autograd wrapper, views that the schema does not mark as views
_FREE = set(_ops(aten, "empty empty_like empty_strided new_empty "
                       "new_empty_strided _unsafe_view _reshape_alias "
                       "lift_fresh set_")
            + _ops(funcol, "wait_tensor _wrap_tensor_autograd"))
# in-place ops that write their first argument without reading it
_WRITE_ONLY = {aten.fill_, aten.zero_, aten.normal_, aten.uniform_,
               aten.random_, aten.bernoulli_, aten.exponential_}
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.prod, aten.logsumexp, aten.norm,
               aten.linalg_vector_norm, aten.var, aten.std, aten.var_mean,
               aten.std_mean, aten.argmax, aten.argmin, aten.any, aten.all,
               aten.cumsum, aten.cumprod, aten._softmax, aten._log_softmax,
               aten._softmax_backward_data, aten._log_softmax_backward_data,
               aten.nll_loss_forward, aten.nll_loss_backward, aten.topk,
               aten.sort}
_TRANSCENDENTAL = {aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p,
                   aten.log2, aten.log10, aten.tanh, aten.sigmoid,
                   aten.rsqrt, aten.sqrt, aten.pow, aten.cos, aten.sin,
                   aten.atan2, aten.erf, aten.erfinv, aten._softmax,
                   aten._log_softmax, aten.logsumexp, aten.gelu,
                   aten.silu, aten.reciprocal}


@contextlib.contextmanager
def sharding_propagation_unseen():
    """For the block, DTensor's sharding propagation (which runs each op
    once more, on fake tensors of the global shapes, to learn its
    output's shapes) runs with every dispatch mode off, so that a counter
    or a memory tracker sees only the local ops a rank runs."""
    real = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(real, "unseen", False):            # nested: already off
        yield
        return

    def unseen(self, op_schema):
        with _disable_current_modes():
            return real(self, op_schema)

    unseen.unseen = True
    ShardingPropagator._propagate_tensor_meta_non_cached = unseen
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = real


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _collective_bytes(func, args, kwargs, out) -> tuple[int, int]:
    """(in, out) bytes of a collective: the schema's ``output*``
    arguments (or its result) out, the rest of its tensors in; an op that
    reduces in place (all-reduce, broadcast, send / recv) moves its
    tensors both ways."""
    ins, outs = 0, 0
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    for name, val in named.items():
        n = sum(_nbytes(x) for x in _tensors(val))
        if name.startswith("out"):
            outs += n
        else:
            ins += n
    if not outs:
        outs = sum(_nbytes(x) for x in _tensors(out)
                   if not isinstance(x, torch.ScriptObject))
        if func._schema.name.startswith("c10d::"):
            outs = ins               # in place: the result is the work handle
    return ins, outs


class CostCounter(TorchDispatchMode):
    """Counts flops, bytes, collectives and kernel work of the ops run
    while it is entered (module docstring); ``summary()`` returns them.
    Enter it inside the ``FakeTensorMode`` of a dry run, so that it sees
    each op before the fake mode runs it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.coll: dict = {}
        self.kernels: dict = {}
        self.by_site: dict = {}
        self._inside = 0            # depth of kernel launches open
        self._unseen = None

    # the hooks of ``kernels/counting.launch``
    def enter_kernel(self, name: str, flops: int, nbytes: int) -> None:
        if self._inside == 0:
            k = self.kernels.setdefault(name, {"count": 0, "flops": 0,
                                               "bytes": 0})
            k["count"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.flops += flops
            self.bytes += nbytes
            self._site(f"kernel {name}", "", nbytes)
        self._inside += 1

    def exit_kernel(self) -> None:
        self._inside -= 1

    def __enter__(self):
        self._unseen = sharding_propagation_unseen()
        self._unseen.__enter__()
        counting.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        counting.COUNTERS.remove(self)
        self._unseen.__exit__(*exc)
        return super().__exit__(*exc)

    def _site(self, op: str, type_str: str, nbytes: float) -> None:
        key = (op, type_str)
        self.by_site[key] = self.by_site.get(key, 0.0) + nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # DTensor runs its local ops through us
        out = func(*args, **kwargs)
        if self._inside or func.is_view or func._overloadpacket in _FREE:
            return out
        packet = func._overloadpacket
        kind = _COLLECTIVE_OPS.get(packet)
        if kind is not None:
            in_b, out_b = _collective_bytes(func, args, kwargs, out)
            slot = self.coll.setdefault(kind, {"count": 0, "in_bytes": 0,
                                               "out_bytes": 0,
                                               "wire_bytes": 0})
            slot["count"] += 1
            slot["in_bytes"] += in_b
            slot["out_bytes"] += out_b
            slot["wire_bytes"] += max(in_b, out_b)
            self.bytes += in_b + out_b
            self._site(kind, "", in_b + out_b)
            return out
        outs = _tensors(out)
        if not outs:
            return out               # a query of metadata: no launch
        if packet in _WRITE_ONLY:
            ins = []
        elif packet is aten.copy_:
            ins = _tensors(args[1:])
        else:
            ins = _tensors((args, kwargs))
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes += nbytes
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet in _REDUCTIONS:
            self.flops += ins[0].numel() if ins else 0
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(x.numel() for x in outs)
        if packet in _TRANSCENDENTAL:
            self.transcendentals += sum(x.numel() for x in outs)
        o = outs[0]
        self._site(str(packet).split(".")[-1],
                   f"{str(o.dtype).split('.')[-1]}{list(o.shape)}"[:64],
                   nbytes)
        return out

    def summary(self, top_k: int = 0) -> dict:
        """The counts so far, under ``hlo_analysis.analyze``'s keys (and
        ``kernels``); ``top_k`` > 0 adds ``top_bytes``, the sites (op,
        output type) that moved the most bytes."""
        out = {
            "flops": self.flops,
            "bytes": self.bytes,
            "transcendentals": self.transcendentals,
            "collectives": {k: dict(v) for k, v in self.coll.items()},
            "collective_wire_bytes": sum(v["wire_bytes"]
                                         for v in self.coll.values()),
            "collective_count": sum(v["count"] for v in self.coll.values()),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }
        if top_k:
            top = sorted(self.by_site.items(), key=lambda kv: -kv[1])[:top_k]
            out["top_bytes"] = [{"op": k[0], "type": k[1], "bytes": v}
                                for k, v in top]
        return out


class PeakTracker(TorchDispatchMode):
    """The peak bytes of live storages while it is entered: every storage
    an op returns counts from that op until its last reference dies (a
    weak reference's callback), ``track_external`` adds the storages
    alive before (a step's arguments), a CUDA storage rounded up to the
    caching allocator's 512-byte blocks.  The same accounting as torch's
    ``MemTracker`` (``torch.distributed._tools.mem_tracker``), whose peak
    it equals, without its per-module and per-category books, which cost
    most of a dry run's host time.  A storage resized outside the
    dispatcher (``UntypedStorage.resize_``) is not seen; the port resizes
    none.  Enter it inside the dry run's ``FakeTensorMode``; DTensor's
    sharding propagation runs unseen (``sharding_propagation_unseen``)."""

    def __init__(self):
        super().__init__()
        self.current = 0
        self.peak = 0
        self._live: dict = {}        # id(storage) -> [weakref, bytes, device]

    @staticmethod
    def _bytes(st, device) -> int:
        n = st.nbytes()
        return -(-n // 512) * 512 if device.type == "cuda" else n

    def _gone(self, key) -> None:
        rec = self._live.pop(key, None)
        if rec is not None:
            self.current -= rec[1]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        rec = self._live.get(key)
        n = self._bytes(st, t.device)
        if rec is not None and rec[0]() is st:
            self.current += n - rec[1]          # resized in place
            rec[1] = n
            return
        self._live[key] = [weakref.ref(st, lambda _, k=key: self._gone(k)),
                           n, t.device]
        self.current += n

    def track_external(self, *tensors: torch.Tensor) -> None:
        for t in tensors:
            self._track(t)
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # DTensor runs its local ops through us
        if func is funcol.wait_tensor.default and isinstance(
                args[0], FakeTensor):
            # a fake wait returns a new tensor where a real one returns
            # its argument (as ``MemTracker`` treats it)
            return args[0]
        out = func(*args, **(kwargs or {}))
        for x in ((out,) if isinstance(out, torch.Tensor)
                  else tree_leaves(out)):
            if isinstance(x, torch.Tensor):
                self._track(x)
        if self.current > self.peak:
            self.peak = self.current
        return out


def analyze(fn, *args, top_k: int = 0, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run once under a ``CostCounter``: its
    counts (``CostCounter.summary``)."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.summary(top_k)

"""Logical-axis partitioning on a ``torch.distributed`` ``DeviceMesh``
(the JAX package's ``repro/sharding/partitioning.py``).

Model code names each parameter's axes with logical names
(``LanguageModel.param_axes()``); ``ShardingRules`` maps them onto mesh
axes.  Rules are candidate lists: resolution checks (a) that the tensor
dim divides by the product of the candidate's mesh axes and (b) that no
mesh axis is used twice within one spec, and falls back to replication
for that dim.  So one rule set covers heads=96 (16-way over ``model``)
and heads=10 (heads replicated, FSDP on d_model).

Parallelism modes expressed by the rules:
  DP    batch -> ('pod', 'data')
  TP    mlp/heads/vocab/mach_rb/experts -> 'model'
  FSDP  embed (the d_model dim of weights) -> 'data'   [fsdp=True]
  SP    seq -> 'model'                                 [sp=True]
  EP    experts -> 'model' when E divides

A spec is a tuple with one entry per tensor dim, trailing ``None``s
trimmed: ``None`` (replicated), a mesh axis name, or a tuple of names
(one dim over several axes, the first major) — entry for entry the JAX
package's ``PartitionSpec``.  ``placements`` turns it into ``DTensor``
placements, ``place`` puts a tree of tensors on the mesh, ``gather``
brings it back whole, and ``materialize`` brings a leaf whole where the
model uses it (FSDP: the backward reduce-scatters its gradient).  The
rules read only a mesh's axis names and sizes, so they run on a
``DeviceMesh`` and on any object with a ``shape`` dict and
``axis_names`` (the JAX tests' ``FakeMesh``).

Three parts of a model split by the placements of their params (Megatron's
tensor parallelism, where JAX's XLA partitions the same products).
Rank k of the n ranks on the mesh dims that shard a param's split dim
(major first, ``shard_range``) computes its own range of that dim: the
param's gather keeps those dims (``materialize(keep=)``), the rows go
into the split (``RangeSplit.into``: the identity forward, dh summed
over the split's ranks backward) and the partial results come out of it
summed (``RangeSplit.out_of``).
- The MACH head by repetition: where the mesh dims that split its
  ``mach_rb`` dim divide R, rank k owns repetitions [k·R/n, (k+1)·R/n),
  whose columns its shard holds (``repetition_range``, ``head_split``);
  the per-token partial losses come out summed.  Where n does not
  divide R (a shard boundary inside a repetition, e.g. R = 8 on the
  (16, 16) mesh) the head is gathered whole and every rank computes
  every repetition.
- A decoder block's self-attention by query heads and its dense MLP by
  hidden columns (``block_split``): the attention splits where q's and
  o's heads dims are sharded over the same mesh dims m (and k and v are
  each sharded on their kv-heads dim over m, or replicated over m); the
  MLP where wi's (and wg's) last dim and wo's first dim are.  Under
  GQA a rank reads the kv heads its query heads read: its own shard of
  k and v, or, where the rules leave them replicated, those heads cut
  from the whole k and v, whose gradient is then summed over m
  (``kv_heads``); the attention then splits only where a rank's H/n
  query heads hold whole groups or lie inside one.  The block's two outputs come out summed over m; the
  residual stream stays whole on every rank.  Elsewhere (a dim the
  rules leave replicated, e.g. recurrentgemma's 10 heads on 8 ranks)
  that part runs whole on every rank, as do the RG-LRU, the xLSTM
  blocks, the cross-attention, the embedding and the OAA head.
- An MoE block's routed experts by expert or by columns
  (``expert_plan``): by expert (EP) where wi's, wg's and wo's expert
  dims are sharded over the same mesh dims m (the rules shard them from
  ``experts`` where n divides E), rank k owning experts [k·E/n,
  (k+1)·E/n); else by columns (expert TP) where wi's and wg's last dims
  and wo's hidden dim are (the rules shard ``mlp`` there where n divides
  d_ff), rank k owning every expert's columns [k·F/n, (k+1)·F/n); else
  the experts run whole.  The shared experts' MLP splits by the dense
  MLP's rule; the router and ``shared_gate`` never split.  Every rank
  routes the whole input, so the routing is the same on every rank of
  m; the gates go into the split (dgate summed over m backward) and the
  float32 partial outputs come out summed.
With one rank on the split's dims ``into`` and ``out_of`` are the
identity, and on one device (plain tensors) nothing splits.

Where the port differs (ROADMAP.md §3): ``constrain`` is the identity,
since the model runs on whole per-rank tensors, or on the ranges a
split gives a rank; the trainer refuses ``sp``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.checkpoint.manager import (tree_flatten, tree_leaves,
                                            tree_paths, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    fsdp: bool = True
    sp: bool = False
    mach_pod_parallel: bool = False   # MACH R-heads sharded over 'pod'

    def table(self, mesh) -> dict:
        has_pod = "pod" in _view(mesh).axis_names
        batch = ("pod", "data") if has_pod else ("data",)
        rules = {
            "batch": [batch, ("data",), None],
            "seq": [("model",), None] if self.sp else [None],
            "embed": [("data",), None] if self.fsdp else [None],
            "mlp": [("model",), None],
            "heads": [("model",), None],
            "kv_heads": [("model",), None],
            "qkv": [None],
            "vocab": [("model",), None],
            "experts": [("model",), None],
            "layers": [None],
            None: [None],
        }
        if self.mach_pod_parallel and has_pod:
            # the R·B dim over (pod, model): pods own disjoint subsets of
            # the R repetitions, the paper's embarrassing parallelism
            rules["mach_rb"] = [("pod", "model"), ("model",), None]
        else:
            rules["mach_rb"] = [("model",), None]
        return rules


class _MeshShape:
    """A ``DeviceMesh`` seen as the rules see a mesh: ``shape`` (axis ->
    size) and ``axis_names``."""

    def __init__(self, mesh: DeviceMesh):
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.shape))


def _view(mesh):
    return _MeshShape(mesh) if isinstance(mesh, DeviceMesh) else mesh


# ---------------------------------------------------------------------------
# Activation constraints.  Model code calls ``constrain(x, ("batch",
# "seq", None))``; the JAX package then constrains XLA's layout inside
# ``activate(mesh, rules)``.  The port's model runs on whole per-rank
# tensors, so there is nothing to constrain; what it reads of the
# activation is the mesh axes a train step's batch rows split on
# (``materialize``).
# ---------------------------------------------------------------------------

_ACTIVE: list = []


class activate:
    """Keeps (mesh, rules table) in force for the block, as the JAX
    package's ``activate`` does; ``active()`` reads it.  A train step
    also names ``batch_axes``, the mesh axes its batch rows split on:
    ``materialize`` sums the gradients of its uses over them."""

    def __init__(self, mesh, rules_cfg: ShardingRules,
                 batch_axes: Optional[tuple] = None):
        self.entry = (mesh, rules_cfg.table(mesh))
        self.batch_axes = batch_axes

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def active():
    """The innermost ``activate``'s (mesh, rules table), or None."""
    return _ACTIVE[-1].entry if _ACTIVE else None


def constrain(x: torch.Tensor, logical_axes) -> torch.Tensor:
    """The identity (the JAX package's sharding constraint has no
    counterpart on whole per-rank tensors)."""
    return x


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _axis_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def resolve_spec(mesh, rules: dict, logical_axes, shape) -> tuple:
    """(logical axis names per dim, shape) -> spec."""
    mesh = _view(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        choice = None
        for cand in rules.get(name, [None]):
            if cand is None:
                break
            if any(a in used for a in cand):
                continue
            if dim % _axis_size(mesh, cand) != 0:
                continue
            choice = tuple(cand) if len(cand) > 1 else cand[0]
            used.update(cand)
            break
        out.append(choice)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_axes(entry) -> tuple:
    """A spec entry's mesh axes, major first (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> list:
    """A spec as ``DTensor`` placements, one per mesh dim: ``Shard(d)`` on
    each mesh axis that splits tensor dim d, ``Replicate()`` elsewhere.
    A dim over two axes is ``Shard(d)`` on both; ``DTensor`` splits it by
    the mesh's dim order, so its axes must come in that order (the major
    first, as in JAX)."""
    names = _view(mesh).axis_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in spec_axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not in "
                             f"the mesh's order {names}")
        for i in dims:
            out[i] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the JAX package's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def _map_axes(fn, axes, shapes):
    """``fn(axes leaf, shape leaf)`` over an axes tree (tuples of names at
    its leaves) and the tree of tensors it describes."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, v, shapes[k]) for k, v in axes.items()}
    if isinstance(axes, list):
        return [_map_axes(fn, a, s) for a, s in zip(axes, shapes)]
    return fn(axes, shapes)


def params_shardings(mesh, rules_cfg: ShardingRules, axes_tree,
                     shapes_tree) -> Any:
    """axes_tree: tuples of logical names (``param_axes()``); shapes_tree:
    the matching tensors (``init(device="meta")`` will do).  Returns the
    tree of ``NamedSharding``s."""
    rules = rules_cfg.table(mesh)
    return _map_axes(lambda ax, t: NamedSharding(
        mesh, resolve_spec(mesh, rules, ax, t.shape)), axes_tree, shapes_tree)


def batch_shardings(mesh, rules_cfg: ShardingRules, batch_tree) -> Any:
    """Every batch leaf's dim 0 as 'batch' (with the divisibility
    fallback); dim 1 as 'seq' when ``sp``."""
    rules = rules_cfg.table(mesh)

    def per_leaf(x):
        logical = ["batch"] + (["seq"] if rules_cfg.sp and x.dim() > 1 else
                               [None] * max(0, x.dim() - 1))
        logical += [None] * (x.dim() - len(logical))
        return NamedSharding(mesh, resolve_spec(mesh, rules, logical,
                                                x.shape))

    return tree_unflatten(batch_tree, [per_leaf(x)
                                       for _, x in tree_flatten(batch_tree)])


def state_shardings(mesh, rules_cfg: ShardingRules, model, opt
                    ) -> tuple[Any, Any, Any]:
    """(state_shapes, state_shardings, params_axes) of a ``TrainState``
    for ``model`` (``init(device=)``, ``param_axes()``) and ``opt``,
    built on the meta device (nothing allocated).

    Optimizer moments take their own parameter's sharding.  Every
    optimizer state embeds copies of the params tree under some prefix
    (mu / nu, momentum, master weights), so a moment is matched to its
    parameter by tree path: the longest parameter path that is a suffix
    of the moment's, with the shapes agreeing (Adafactor's factored
    vr / vc share the path, not the shape).  Anything unmatched —
    factored moments, counts, the Python-int step — is replicated."""
    from repro_torch.train.train_state import TrainState, new_train_state

    params_shapes = model.init(device="meta")
    axes = model.param_axes()
    state_shapes = new_train_state(params_shapes, opt)
    p_shard = params_shardings(mesh, rules_cfg, axes, params_shapes)
    rep = NamedSharding(mesh, ())

    index: dict = {}
    for (path, leaf), (_, sh) in zip(tree_paths(params_shapes),
                                     tree_flatten(p_shard)):
        index.setdefault(path, []).append((tuple(leaf.shape), sh))

    def moment_sharding(path, leaf):
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else None
        for start in range(len(path) + 1):     # the longest suffix first
            for pshape, sh in index.get(path[start:], ()):
                if pshape == shape:
                    return sh
        return rep

    opt_shard = tree_unflatten(state_shapes.opt_state, [
        moment_sharding(path, leaf)
        for path, leaf in tree_paths(state_shapes.opt_state)])
    return (state_shapes,
            TrainState(step=rep, params=p_shard, opt_state=opt_shard), axes)


# ---------------------------------------------------------------------------
# Placing trees on a mesh
# ---------------------------------------------------------------------------

def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device a mesh's tensors live on in this process."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def gather(tree) -> Any:
    """Every ``DTensor`` leaf as its whole tensor, the rest as they are.
    A collective: every rank of each leaf's mesh calls it."""
    return tree_unflatten(tree, [
        x.full_tensor() if isinstance(x, DTensor) else x
        for _, x in tree_flatten(tree)])


def place(tree, shardings) -> Any:
    """Every tensor leaf as a ``DTensor`` on its ``NamedSharding``
    (``shardings`` shaped like ``tree``, or one for every leaf); a
    ``DTensor`` leaf is gathered first, so this also moves a tree from
    one mesh to another.  Each rank cuts its own shard from the whole
    tensor it holds (no communication): every rank must hold the same
    values.  A leaf that is not split shares its storage; a ``DTensor``
    leaf already on its sharding stays as it is.  Ints stay."""
    if isinstance(shardings, NamedSharding):
        shard_leaves = [shardings] * len(tree_flatten(tree))
    else:
        shard_leaves = [s for _, s in tree_flatten(shardings)]
    pairs = tree_flatten(tree)
    if len(shard_leaves) != len(pairs):
        raise ValueError(f"{len(shard_leaves)} shardings for "
                         f"{len(pairs)} leaves")
    out = []
    for (_, x), sh in zip(pairs, shard_leaves):
        if isinstance(x, DTensor):
            if x.device_mesh == sh.mesh and \
                    list(x.placements) == sh.placements:
                out.append(x)
                continue
            x = x.full_tensor()
        if isinstance(x, torch.Tensor):
            x = distribute_tensor(x.to(mesh_device(sh.mesh)), sh.mesh,
                                  sh.placements, src_data_rank=None)
        out.append(x)
    return tree_unflatten(tree, out)


def materialize(tree, keep: tuple = ()) -> Any:
    """Every ``DTensor`` leaf whole for its use here, the rest (plain
    tensors: one device) as they are.  The model calls it where it reads
    a param, so under FSDP a rank holds a leaf whole only while it uses
    it.  The whole tensor's gradient is this rank's share: the backward
    sums it over the innermost ``activate``'s ``batch_axes`` (each
    rank's rows give a share of the batch's gradient; the other axes
    hold replicas) onto the leaf's own placements — a reduce-scatter on
    the axes that split it, an all-reduce on those that do not — as it
    leaves this use.  ``keep`` names the mesh dims of a split use (a
    ``RangeSplit``'s ``dims``), where each rank computes its own range:
    a leaf sharded on such a dim stays this rank's shard there, and its
    gradient there is taken as whole, neither summed nor sliced (each
    rank's columns are its own); a leaf replicated there is whole, and
    its gradient, this rank's part of the split use, is summed there too
    (k and v cut to a rank's kv heads).  A collective: every rank of the
    mesh calls it, in the same order.  Raises on a ``DTensor`` outside a
    step's activation on its mesh."""
    leaves = tree_leaves(tree)
    if not any(isinstance(x, DTensor) for x in leaves):
        return tree
    act = _active_step()
    mesh = act.entry[0]
    keep = tuple(keep)
    summed = tuple(i for i, a in enumerate(mesh.mesh_dim_names)
                   if a in act.batch_axes or i in keep)
    out = []
    for x in leaves:
        if isinstance(x, DTensor):
            if x.device_mesh != mesh:
                raise ValueError("materialize: a leaf on another mesh than "
                                 "the active one")
            x = _Gather.apply(x, summed, keep)
        out.append(x)
    return tree_unflatten(tree, out)


def _active_step():
    act = _ACTIVE[-1] if _ACTIVE else None
    if act is None or act.batch_axes is None:
        raise ValueError("materialize: a DTensor param outside a train "
                         "step's activate(mesh, rules, batch_axes=)")
    return act


class _Gather(torch.autograd.Function):
    """A ``DTensor`` -> its whole tensor, all-gathered from the local
    shard over each mesh dim that splits it but those in ``kept`` (the
    minor dim first, so a tensor dim over two mesh dims comes back major
    first, as ``DTensor`` splits it).  Backward: the whole gradient,
    summed over the mesh dims ``summed`` and cut to the shard — a
    reduce-scatter where a summed dim splits the leaf, an all-reduce
    where it does not, a local slice where an unsummed dim splits it —
    as a ``DTensor`` on the leaf's placements; a kept dim that splits the
    leaf is left as it is.  A mesh dim of one rank moves nothing.  The
    same result as ``redistribute`` to ``Replicate()`` and ``to_local``
    with ``Partial("sum")`` gradient placements, without ``DTensor``'s
    per-call dispatch, whose host time made tinyllama-1.1b's step 6.8%
    slower at world 1 on an H100 (the redistribute, its backward and the
    per-layer selects of every leaf)."""

    @staticmethod
    def forward(ctx, x: DTensor, summed: tuple, kept: tuple):
        # the gradient takes x's spec (mesh, placements, global shape,
        # stride and dtype) as it is: ``DTensor.from_local`` would build
        # a new one, host time on every use of every leaf
        ctx.spec, ctx.summed, ctx.kept = x._spec, summed, kept
        mesh = x.device_mesh
        whole = x.to_local()               # its local tensor (no grad here)
        for i in reversed(range(mesh.ndim)):
            p = x.placements[i]
            n = mesh.size(i)
            if isinstance(p, Shard) and n > 1 and i not in kept:
                whole = whole.contiguous()
                parts = whole.new_empty((n * whole.shape[0],)
                                        + tuple(whole.shape[1:]))
                torch.distributed.all_gather_into_tensor(
                    parts, whole, group=mesh.get_group(i))
                if p.dim:
                    parts = torch.cat(parts.chunk(n), dim=p.dim)
                whole = parts
        return whole.view_as(whole)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        mesh = ctx.spec.mesh
        for i, p in enumerate(ctx.spec.placements):
            n = mesh.size(i)
            if n == 1 or (i in ctx.kept and isinstance(p, Shard)):
                continue
            if i in ctx.summed and isinstance(p, Shard):
                out = torch.empty_like(g.narrow(p.dim, 0, g.shape[p.dim] // n),
                                       memory_format=torch.contiguous_format)
                torch.distributed.reduce_scatter_tensor(
                    out, torch.cat(g.chunk(n, dim=p.dim), dim=0)
                    if p.dim else g.contiguous(), group=mesh.get_group(i))
                g = out
            elif i in ctx.summed:
                g = g.contiguous().clone()
                torch.distributed.all_reduce(g, group=mesh.get_group(i))
            elif isinstance(p, Shard):
                g = g.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
        return DTensor(g, ctx.spec, requires_grad=False), None, None


# ---------------------------------------------------------------------------
# Split computation: the MACH head by repetition over the mesh axes of its
# ``mach_rb`` dim (the JAX package shards that dim over ``model``, or
# ``(pod, model)`` with ``mach_pod_parallel``, "exactly like a
# vocab-sharded softmax"), a decoder block's self-attention by heads and
# its MLP by hidden columns over those of ``heads`` and ``mlp``, an MoE
# block's experts by expert or by columns over those of ``experts`` or
# ``mlp``.
# ---------------------------------------------------------------------------

def _shard_index(mesh, dims) -> tuple[int, int]:
    """(this rank's index, the count) over mesh dims ``dims``, the first
    major (``DTensor``'s order for a tensor dim over several mesh dims)."""
    coord = mesh.get_coordinate()
    k, n = 0, 1
    for i in dims:
        k, n = k * mesh.size(i) + coord[i], n * mesh.size(i)
    return k, n


def shard_range(leaf, dim: int) -> Optional[tuple[int, int, tuple]]:
    """(k, n, dims) of tensor dim ``dim`` of a ``DTensor`` leaf: the mesh
    dims that shard it (in the mesh's order, the first major), n ranks
    in all, this rank the k-th of them, so its shard holds the k-th of
    n equal ranges of the dim.  None for a plain tensor (one device)."""
    if not isinstance(leaf, DTensor):
        return None
    dim %= leaf.dim()
    dims = tuple(i for i, p in enumerate(leaf.placements)
                 if isinstance(p, Shard) and p.dim == dim)
    k, n = _shard_index(leaf.device_mesh, dims)
    return k, n, dims


def repetition_shards(mesh, spec_entry, num_repetitions: int
                      ) -> Optional[int]:
    """The number n of ranks that split a MACH head's R·B dim, placed by
    ``spec_entry`` (its spec's entry: ``None``, an axis or a tuple of
    axes) on ``mesh`` (a ``DeviceMesh`` or a ``FakeMesh``), where n
    divides R, so each owns R / n whole repetitions; None where it does
    not (a shard boundary inside a repetition)."""
    n = _axis_size(_view(mesh), spec_axes(spec_entry))
    return n if num_repetitions % n == 0 else None


def repetition_range(leaf, num_repetitions: int
                     ) -> Optional[tuple[int, int]]:
    """This rank's repetitions [r0, r1) of a MACH head leaf whose last
    dim holds the R·B columns, repetition major: where the mesh dims that
    split that dim, n ranks in all, divide R, rank k of them (major first
    over those dims) owns [k·R/n, (k+1)·R/n), exactly the columns of its
    local shard.  None for a plain tensor (one device) and where n does
    not divide R."""
    sr = shard_range(leaf, -1)
    if sr is None or num_repetitions % sr[1]:
        return None
    k, n, _ = sr
    per = num_repetitions // n
    return k * per, (k + 1) * per


def _step_batch(mesh) -> tuple:
    """The mesh dims of the active step's ``batch_axes``."""
    act = _active_step()
    return tuple(i for i, a in enumerate(mesh.mesh_dim_names)
                 if a in act.batch_axes)


def head_split(leaf, num_repetitions: int) -> Optional["RangeSplit"]:
    """How a sharded step computes the MACH head whose kernel is
    ``leaf`` (d, R·B): None on one device (a plain tensor), else a
    ``RangeSplit`` on this rank's repetitions (``repetition_range``), or
    on all R with no split dims where the split does not apply (the head
    gathered whole, as every other param).  Raises outside a step's
    activation, as ``materialize`` does."""
    if not isinstance(leaf, DTensor):
        return None
    mesh = leaf.device_mesh
    batch = _step_batch(mesh)
    reps = repetition_range(leaf, num_repetitions)
    if reps is None:
        return RangeSplit(mesh, 0, num_repetitions, (), batch)
    return RangeSplit(mesh, reps[0], reps[1], shard_range(leaf, -1)[2], batch)


def kv_heads(q0: int, q1: int, num_heads: int, num_kv_heads: int
             ) -> tuple[int, int]:
    """The kv heads [k0, k1) that query heads [q0, q1) read under GQA
    (query head i reads kv head i // G, G = H / KV): a rank's heads hold
    whole groups (G divides q1 - q0) or lie inside one (q1 - q0 divides
    G), so the kernels' grouping of the local heads (each local kv head
    serving the next (q1 - q0) / (k1 - k0) query heads) reads exactly
    those; ``split_plan`` keeps the attention whole elsewhere."""
    g, per = num_heads // num_kv_heads, q1 - q0
    if per % g and g % per:
        raise ValueError(f"query heads [{q0}, {q1}) in groups of {g} "
                         f"straddle a group")
    return q0 // g, (q1 - 1) // g + 1


@dataclasses.dataclass(frozen=True)
class MoESplit:
    """A sharded step's MoE block on this rank (``block_split``): its
    routed experts by expert (``experts``: the rank's experts [r0, r1),
    EP) or by columns (``columns``: every expert's hidden columns [r0,
    r1), expert TP), at most one of the two (neither: the experts run
    whole), and ``shared`` the shared experts' MLP by hidden columns
    (None: it runs whole, or the block has none).  The rank's shards of
    wi, wg and wo (and of the shared MLP's) hold exactly its ranges; the
    router and ``shared_gate`` are whole."""
    experts: Optional["RangeSplit"] = None
    columns: Optional["RangeSplit"] = None
    shared: Optional["RangeSplit"] = None

    @property
    def routed(self) -> Optional["RangeSplit"]:
        """The routed experts' split, either mode (None: whole)."""
        return self.experts if self.experts is not None else self.columns


@dataclasses.dataclass(frozen=True)
class BlockSplit:
    """A sharded step's decoder block on this rank (``block_split``):
    ``attn`` its self-attention's query heads [r0, r1) over the mesh dims
    ``attn.dims`` (None: the attention runs whole), ``kv`` the kv heads
    [k0, k1) of the whole k and v it reads (``kv_heads``; None where its
    shards of k and v are those heads), ``mlp`` the MLP's hidden columns [r0, r1)
    (None: the MLP runs whole), ``moe`` an MoE block's experts (None:
    they run whole, or the block has none).  The rank's shards of q, o,
    wi, wg and wo hold exactly its ranges."""
    attn: Optional["RangeSplit"]
    kv: Optional[tuple[int, int]]
    mlp: Optional["RangeSplit"]
    moe: Optional[MoESplit] = None


def dim_axes(leaf: DTensor) -> tuple:
    """A ``DTensor``'s layout: per tensor dim, the mesh axes that shard
    it (a tuple of names in the mesh's order, ``()`` where none do), as
    ``spec_axes`` reads a spec's entries."""
    names = leaf.device_mesh.mesh_dim_names
    return tuple(tuple(names[i] for i, p in enumerate(leaf.placements)
                       if isinstance(p, Shard) and p.dim == d)
                 for d in range(leaf.dim()))


def split_plan(mesh, attn: Optional[dict], mlp: Optional[dict],
               num_heads: int, num_kv_heads: int
               ) -> tuple[tuple, bool, tuple]:
    """Which parts of a decoder block split on ``mesh`` (a ``DeviceMesh``
    or a ``FakeMesh``), from its leaves' layouts (``dim_axes``, or a
    spec's entries): ``attn`` maps q (d, H, hd), k, v (d, KV, hd) and o
    (H, hd, d), ``mlp`` maps wi, [wg] (d, F) and wo (F, d), each to its
    layout (None: the block has no such part).  Returns (the attention's
    mesh axes, whether k and v are split with it, the MLP's mesh axes),
    ``()`` for a part that runs whole.
    - The attention splits over the axes m that shard q's heads dim where
      they shard o's too, and k and v each on their kv-heads dim, or
      shard neither (replicated over m: the rank cuts its kv heads, so
      its H/n query heads must hold whole GQA groups or lie inside one).
    - The MLP splits over the axes that shard wi's and wg's last dims
      where they shard wo's first too."""
    a_axes, kv_split, m_axes = (), False, ()
    if attn is not None:
        m = attn["q"][1]
        if m and attn["o"][0] == m:
            kv = [attn["k"], attn["v"]]
            per = num_heads // _axis_size(_view(mesh), m)
            g = num_heads // num_kv_heads
            if all(x[1] == m for x in kv):
                a_axes, kv_split = m, True
            elif not any(a in axes for x in kv for axes in x for a in m) \
                    and (per % g == 0 or g % per == 0):
                a_axes = m
    if mlp is not None:
        m = mlp["wi"][-1]
        if m and mlp.get("wg", mlp["wi"])[-1] == m and mlp["wo"][0] == m:
            m_axes = m
    return a_axes, kv_split, m_axes


def expert_plan(experts: Optional[dict]) -> tuple[str, tuple]:
    """How an MoE block's routed experts split, from the layouts of wi,
    [wg] (E, d, F) and wo (E, F, d) (``dim_axes``, or a spec's entries;
    None: no experts): ("experts", m) where the mesh axes m shard the
    expert dim of all of them (EP), else ("columns", m) where m shard
    wi's and wg's last dim and wo's hidden dim (expert TP), else ("",
    ()): the experts run whole.  The rules never shard both on one axis,
    so EP, where n divides E, leaves the columns whole."""
    if experts is None:
        return "", ()
    wi, wo = experts["wi"], experts["wo"]
    wg = experts.get("wg", wi)
    if wi[0] and wg[0] == wi[0] and wo[0] == wi[0]:
        return "experts", wi[0]
    if wi[-1] and wg[-1] == wi[-1] and wo[1] == wi[-1]:
        return "columns", wi[-1]
    return "", ()


def block_split(params: dict) -> Optional[BlockSplit]:
    """How a sharded step computes the block whose params are ``params``
    (one period's slice, ``DTensor`` leaves): None on one device (plain
    tensors) and for a block with neither self-attention, MLP nor MoE;
    else a ``BlockSplit`` by the placements alone (``split_plan``,
    ``expert_plan``): rank k of the n ranks on a split's mesh axes
    computes query heads [k·H/n, (k+1)·H/n) and the kv heads they read
    (``kv_heads``), hidden columns [k·F/n, (k+1)·F/n), experts [k·E/n,
    (k+1)·E/n) or every expert's columns [k·F/n, (k+1)·F/n).  Raises
    outside a step's activation, as ``materialize`` does."""
    parts = {key: params[key] for key in ("attn", "mlp", "moe")
             if key in params}
    first = next(iter(tree_leaves(parts)), None)
    if not isinstance(first, DTensor):
        return None
    mesh = first.device_mesh
    batch = _step_batch(mesh)
    kernels = {key: {name: leaf["kernel"] for name, leaf in part.items()}
               for key, part in parts.items() if key != "moe"}
    heads = (kernels["attn"]["q"].shape[1], kernels["attn"]["k"].shape[1]) \
        if "attn" in kernels else (1, 1)
    a_axes, kv_split, m_axes = split_plan(mesh, *(
        {name: dim_axes(x) for name, x in kernels[key].items()}
        if key in kernels else None for key in ("attn", "mlp")), *heads)

    def split(leaf, dim):            # the plan's axes shard this dim
        k, n, dims = shard_range(leaf, dim)
        per = leaf.shape[dim] // n
        return RangeSplit(mesh, k * per, (k + 1) * per, dims, batch)

    attn = mlp = kv = None
    if a_axes:
        q, k = kernels["attn"]["q"], kernels["attn"]["k"]
        attn = split(q, 1)
        if not kv_split:
            kv = kv_heads(attn.r0, attn.r1, q.shape[1], k.shape[1])
    if m_axes:
        mlp = split(kernels["mlp"]["wo"], 0)
    moe = _moe_split(mesh, parts["moe"], split) if "moe" in parts else None
    return BlockSplit(attn, kv, mlp, moe)


def _moe_split(mesh, params: dict, split) -> Optional[MoESplit]:
    """An MoE block's ``MoESplit`` by ``expert_plan`` and, for its shared
    MLP, ``split_plan``'s MLP rule (``split(leaf, dim)``: the range of
    ``dim`` the leaf's shard holds); None where nothing splits."""
    experts = {name: params[name]["kernel"] for name in ("wi", "wg", "wo")
               if name in params}
    how, _ = expert_plan({name: dim_axes(x) for name, x in experts.items()})
    routed = split(experts["wo"], 0 if how == "experts" else 1) \
        if how else None
    shared = None
    if "shared" in params:
        kernels = {name: leaf["kernel"]
                   for name, leaf in params["shared"].items()}
        if split_plan(mesh, None, {name: dim_axes(x)
                                   for name, x in kernels.items()}, 1, 1)[2]:
            shared = split(kernels["wo"], 0)
    if routed is None and shared is None:
        return None
    return MoESplit(routed if how == "experts" else None,
                    routed if how == "columns" else None, shared)


@dataclasses.dataclass(frozen=True)
class RangeSplit:
    """A sharded step's split computation on this rank: [r0, r1), the
    range it computes of the split dim (a MACH head's repetitions, an
    attention's query heads, an MLP's hidden columns), the mesh dims
    ``dims`` that shard that dim (kept by its params' gather) and
    ``batch`` that split the step's rows.  The rank computes its range
    on the rows of every rank of ``rows`` = batch ∩ dims (``pod`` for a
    MACH head under ``mach_pod_parallel``, else none), so the partial
    results sum over ``summed`` = dims − batch; sums over the rows (the
    bucket selection's batch mean and label buckets) reduce over
    ``reduced`` = batch − dims.  With one rank on every such dim,
    ``into`` and ``out_of`` are the identity."""
    mesh: Any
    r0: int
    r1: int
    dims: tuple
    batch: tuple

    @property
    def rows(self) -> tuple:
        return tuple(i for i in self.dims if i in self.batch)

    @property
    def summed(self) -> tuple:
        return tuple(i for i in self.dims if i not in self.batch)

    @property
    def reduced(self) -> tuple:
        return tuple(i for i in self.batch if i not in self.dims)

    def moves(self, dims) -> bool:
        """Whether any mesh dim of ``dims`` has more than one rank."""
        return any(self.mesh.size(i) > 1 for i in dims)

    def into(self, h: torch.Tensor) -> torch.Tensor:
        """The hidden states (rows, ...) going into the split computation:
        gathered over ``rows``; the backward sums dh over ``summed``
        (every rank of the other ranges) and hands each rank of ``rows``
        its rows' share (Megatron's f where ``rows`` is empty)."""
        if not self.moves(self.rows + self.summed):
            return h
        return _IntoSplit.apply(h, self)

    def out_of(self, x: torch.Tensor) -> torch.Tensor:
        """Partial results (rows, ...) leaving the split computation (a
        head's per-token losses, a block's attention or MLP output):
        summed over ``summed``, in x's dtype, and each rank of ``rows``
        keeps its own rows' sum; the backward gathers the gradient's rows
        back (Megatron's g where ``rows`` is empty)."""
        if not self.moves(self.rows + self.summed):
            return x
        return _OutOfSplit.apply(x, self)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (rows, ...), no gradient, gathered over ``rows`` as
        ``into`` gathers h (the labels of the rows the head computes)."""
        return _gather_rows(x, self.mesh, self.rows)

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over ``reduced`` (no gradient)."""
        return _all_reduce(x, self.mesh, self.reduced)

    def max_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s largest entries over ``reduced`` (no gradient)."""
        return _all_reduce(x, self.mesh, self.reduced,
                           torch.distributed.ReduceOp.MAX)

    def max_split(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s largest entries over ``dims`` (no gradient)."""
        return _all_reduce(x, self.mesh, self.dims,
                           torch.distributed.ReduceOp.MAX)


def _all_reduce(x, mesh, dims, op=torch.distributed.ReduceOp.SUM):
    """``x`` reduced over each mesh dim of ``dims`` in turn (a copy)."""
    x = x.contiguous().clone()
    for i in dims:
        if mesh.size(i) > 1:
            torch.distributed.all_reduce(x, op=op, group=mesh.get_group(i))
    return x


def _gather_rows(x, mesh, dims):
    """``x``'s rows (dim 0) all-gathered over ``dims``, the minor dim
    first, so the rows come out major first (as a batch splits them)."""
    for i in reversed(dims):
        n = mesh.size(i)
        if n > 1:
            x = x.contiguous()
            parts = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
            torch.distributed.all_gather_into_tensor(
                parts, x, group=mesh.get_group(i))
            x = parts
    return x


def _scatter_rows(x, mesh, dims):
    """``x``'s rows (dim 0) reduce-scattered over ``dims``, the major dim
    first: each rank keeps the sum of its own rows (``_gather_rows``'s
    adjoint)."""
    for i in dims:
        n = mesh.size(i)
        if n > 1:
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            torch.distributed.reduce_scatter_tensor(
                out, x.contiguous(), group=mesh.get_group(i))
            x = out
    return x


class _IntoSplit(torch.autograd.Function):
    """h into a split computation: rows gathered over the split's
    ``rows``; backward: dh summed over ``summed``, then reduce-scattered
    over ``rows`` (plain collectives, as ``_Gather``)."""

    @staticmethod
    def forward(ctx, h, split: RangeSplit):
        ctx.split = split
        out = _gather_rows(h, split.mesh, split.rows)
        return out.view_as(out)          # a new tensor even where h is

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        g = _all_reduce(g, s.mesh, s.summed)
        return _scatter_rows(g, s.mesh, s.rows), None


class _OutOfSplit(torch.autograd.Function):
    """Partial results out of a split computation: summed over the
    split's ``summed``, reduce-scattered over ``rows``; backward: the
    gradient's rows gathered over ``rows``."""

    @staticmethod
    def forward(ctx, x, split: RangeSplit):
        ctx.split = split
        return _scatter_rows(_all_reduce(x, split.mesh, split.summed),
                             split.mesh, split.rows)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return _gather_rows(g, s.mesh, s.rows), None

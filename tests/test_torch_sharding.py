"""The port's partitioning rules against the JAX package's
``repro.sharding.partitioning``: every case of ``tests/test_sharding.py``
on the same ``FakeMesh``es, the port's ``LanguageModel.param_axes()``
against the JAX init's axes for all ten architectures, a sweep of every
parameter's spec over the production meshes and rule sets, and
``state_shardings`` keyed by path.

Specs are compared entry for entry: the port's spec is a tuple, JAX's
``PartitionSpec`` is compared as ``tuple(spec)``.  Placing on a real
``DeviceMesh`` (and the row ranges of a dim over ``("pod", "data")``)
is in ``test_torch_multidevice.py``.
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.distributed.tensor import Replicate, Shard

from repro.optim import make_optimizer as jax_make_optimizer
from repro.sharding import partitioning as jpart
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import LanguageModel
from repro_torch.optim import make_optimizer
from repro_torch.sharding import (ShardingRules, activate, active,
                                  batch_shardings, constrain,
                                  params_shardings, placements,
                                  resolve_spec, state_shardings)
from torch_reference import jax_lm  # noqa: F401  (fixture)


class FakeMesh:
    """resolve_spec only touches .shape and .axis_names."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})
RULES = ShardingRules(fsdp=True, sp=False)


def _jax_rules(rules: ShardingRules):
    return jpart.ShardingRules(fsdp=rules.fsdp, sp=rules.sp,
                               mach_pod_parallel=rules.mach_pod_parallel)


def _spec(mesh, axes, shape, rules=RULES):
    """The port's spec, after checking it equals JAX's."""
    got = resolve_spec(mesh, rules.table(mesh), axes, shape)
    want = jpart.resolve_spec(mesh, _jax_rules(rules).table(mesh), axes,
                              shape)
    assert got == tuple(want), (axes, shape, got, want)
    return got


# ------------------------------------------- tests/test_sharding.py's cases

def test_tp_sharding_divisible():
    assert _spec(MESH1, ("embed", "heads", "qkv"), (12288, 96, 128)) == \
        ("data", "model")


def test_heads_fallback_when_not_divisible():
    assert _spec(MESH1, ("embed", "heads", "qkv"), (2048, 8, 256)) == \
        ("data",)
    assert _spec(MESH1, ("embed", "heads", "qkv"), (2560, 10, 256)) == \
        ("data",)


def test_mqa_kv_replicated():
    assert _spec(MESH1, ("embed", "kv_heads", "qkv"), (6144, 1, 128)) == \
        ("data",)


def test_vocab_and_mach_rb():
    assert _spec(MESH1, ("vocab", "embed"), (256000, 2560)) == \
        ("model", "data")
    assert _spec(MESH1, ("embed", "mach_rb"), (2048, 16384)) == \
        ("data", "model")


def test_axis_conflict_first_wins():
    assert _spec(MESH1, ("experts", "embed", "mlp"), (16, 4096, 1408)) == \
        ("model", "data")
    assert _spec(MESH1, ("experts", "embed", "mlp"), (60, 2048, 1408)) == \
        (None, "data", "model")


def test_batch_uses_pod_axis_when_present():
    assert _spec(MESH2, ("batch", None), (512, 100)) == (("pod", "data"),)
    assert _spec(MESH2, ("batch", None), (1, 100)) == ()


def test_no_fsdp_disables_embed_sharding():
    assert _spec(MESH1, ("embed", "heads", "qkv"), (4096, 32, 128),
                 ShardingRules(fsdp=False)) == (None, "model")


def test_sp_shards_seq():
    rules = ShardingRules(fsdp=True, sp=True)
    assert _spec(MESH1, ("batch", "seq", None), (256, 4096, 8192),
                 rules) == ("data", "model")
    assert _spec(MESH1, ("batch", "seq", None), (256, 1, 8192),
                 rules) == ("data",)


def test_mach_pod_parallel_rule():
    rules = ShardingRules(fsdp=False, mach_pod_parallel=True)
    assert _spec(MESH2, ("embed", "mach_rb"), (2048, 16384), rules) == \
        (None, ("pod", "model"))


class TwoParamModel:
    """Two params of one shape and different shardings."""

    def init(self, generator=None, device=None):
        return {"emb": torch.zeros((64, 128), device=device),
                "head": torch.zeros((64, 128), device=device)}

    def param_axes(self):
        return {"emb": ("embed", "mach_rb"), "head": ("vocab", "embed")}


class DeepModel:
    """Every layer's leaves share terminal path components, and a nested
    ``block.w`` collides with a top-level ``w`` of the same shape and
    another sharding."""

    n_layers = 24

    def init(self, generator=None, device=None):
        p = {"w": torch.zeros((64, 128), device=device),
             "block": {"w": torch.zeros((64, 128), device=device)}}
        for i in range(self.n_layers):
            p[f"layer_{i}"] = {"w": torch.zeros((32, 16), device=device),
                               "b": torch.zeros((16,), device=device)}
        return p

    def param_axes(self):
        a = {"w": ("embed", "mach_rb"), "block": {"w": ("vocab", "embed")}}
        for i in range(self.n_layers):
            a[f"layer_{i}"] = {"w": ("embed", "mlp") if i % 2
                               else ("heads", "embed"), "b": (None,)}
        return a


class _JaxTwin:
    """The JAX package's model protocol (``init(key) -> (params, axes)``)
    over a port test model's tree."""

    def __init__(self, model):
        self.model = model

    def init(self, key):
        p = jax.tree.map(lambda t: jax.numpy.zeros(t.shape),
                         self.model.init(device="meta"))
        return p, self.model.param_axes()


def _specs(tree):
    """{path: spec} of a tree of NamedShardings (port or JAX)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {jax.tree_util.keystr(path): tuple(s.spec) for path, s in flat}


@pytest.mark.parametrize("model", [TwoParamModel(), DeepModel()],
                         ids=["two_params", "deep_colliding_suffixes"])
@pytest.mark.parametrize("opt", ["adamw", "adafactor", "adamw_master"])
def test_state_shardings_keyed_by_path_not_shape(model, opt):
    """Every moment takes its own param's spec (longest path suffix,
    shapes agreeing); Adafactor's factored moments, the counts and the
    step are replicated — leaf for leaf what the JAX package gives on a
    (1, 1) mesh."""
    make = dict(adamw=("adamw", {}), adafactor=("adafactor", {}),
                adamw_master=("adamw", {"master_weights": True}))[opt]
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    mesh = FakeMesh({"data": 1, "model": 1})
    _, jshard, _ = jpart.state_shardings(
        jmesh, jpart.ShardingRules(fsdp=True), _JaxTwin(model),
        jax_make_optimizer(make[0], 1e-3, **make[1]))
    shapes, shard, axes = state_shardings(
        mesh, ShardingRules(fsdp=True), model,
        make_optimizer(make[0], 1e-3, **make[1]))
    assert axes == model.param_axes()
    assert shapes.step == 0 and isinstance(shapes.step, int)
    assert _specs(shard) == _specs(jshard)
    p = shard.params
    assert p["w" if "w" in p else "emb"].spec == ("data", "model")
    # on a (16, 16) mesh the same rules split for real
    _, shard16, _ = state_shardings(MESH1, ShardingRules(fsdp=True), model,
                                    make_optimizer(make[0], 1e-3,
                                                   **make[1]))
    inner = shard16.opt_state
    if opt == "adamw_master":
        assert _specs(inner.master) == _specs(shard16.params)
        inner = inner.inner
    if opt == "adafactor":
        assert set(_specs(inner.vr).values()) == {()}
        assert set(_specs(inner.vc).values()) == {()}
    else:
        assert _specs(inner.mu) == _specs(shard16.params)
        assert _specs(inner.nu) == _specs(shard16.params)
    assert inner.count.spec == () and shard16.step.spec == ()


# ------------------------------------------------ the port's param axes

def _axes_leaves(tree, path=""):
    """{path: axes tuple} of an axes tree (dicts and lists of tuples)."""
    if isinstance(tree, dict):
        return {p: a for k in sorted(tree)
                for p, a in _axes_leaves(tree[k], f"{path}[{k!r}]").items()}
    if isinstance(tree, list):
        return {p: a for i, v in enumerate(tree)
                for p, a in _axes_leaves(v, f"{path}[{i}]").items()}
    return {path: tuple(tree)}


def _shape_leaves(tree, path=""):
    if isinstance(tree, dict):
        return {p: s for k in sorted(tree)
                for p, s in _shape_leaves(tree[k], f"{path}[{k!r}]").items()}
    if isinstance(tree, list):
        return {p: s for i, v in enumerate(tree)
                for p, s in _shape_leaves(v, f"{path}[{i}]").items()}
    return {path: tuple(tree.shape)}


@pytest.fixture(scope="module")
def jax_axes(jax_lm):
    """arch -> (JAX axes by path, JAX shapes by path) of each smoke model
    (``eval_shape``: nothing allocated)."""
    out = {}
    for arch in ARCH_IDS:
        jmodel = jax_lm.models.LanguageModel(
            jax_lm.configs.get_config(arch, smoke=True))
        shapes, axes = jpart.eval_shape_with_axes(jmodel.init,
                                                  jax.random.key(0))
        out[arch] = (_axes_leaves(axes), _shape_leaves(shapes))
    return out


def _port(arch):
    model = LanguageModel(get_config(arch, smoke=True))
    return model, model.init(device="meta"), model.param_axes()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_jax_init(jax_axes, arch):
    """Leaf for leaf (``convert.py``'s mapping is the identity on paths),
    one logical name a dim, for every block kind."""
    model, params, axes = _port(arch)
    want_axes, want_shapes = jax_axes[arch]
    assert _axes_leaves(axes) == want_axes
    assert _shape_leaves(params) == want_shapes
    for path, ax in _axes_leaves(axes).items():
        assert len(ax) == len(want_shapes[path]), path


RULE_SETS = [ShardingRules(fsdp=f, sp=s, mach_pod_parallel=m)
             for f, s, m in itertools.product((True, False), repeat=3)]


@pytest.mark.parametrize("rules", RULE_SETS,
                         ids=lambda r: f"fsdp{int(r.fsdp)}sp{int(r.sp)}"
                                       f"pod{int(r.mach_pod_parallel)}")
@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_param_spec_matches_jax(jax_axes, arch, mesh, rules):
    """The port's ``params_shardings`` on its own axes and shapes against
    JAX's ``resolve_spec`` on JAX's, every leaf."""
    assert rules.table(mesh) == _jax_rules(rules).table(mesh)
    model, params, axes = _port(arch)
    got = _specs(params_shardings(mesh, rules, axes, params))
    want_axes, want_shapes = jax_axes[arch]
    table = _jax_rules(rules).table(mesh)
    want = {path: tuple(jpart.resolve_spec(mesh, table, ax,
                                           want_shapes[path]))
            for path, ax in want_axes.items()}
    assert got == want


# ---------------------------------------------------- placements, batches

def test_placements_of_a_spec():
    assert placements(("data", "model"), MESH1) == [Shard(0), Shard(1)]
    assert placements((None, "data"), MESH1) == [Shard(1), Replicate()]
    assert placements(((("pod", "data")),), MESH2) == \
        [Shard(0), Shard(0), Replicate()]
    assert placements((None, ("pod", "model")), MESH2) == \
        [Shard(1), Replicate(), Shard(1)]
    assert placements((), MESH2) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements(((("data", "pod")),), MESH2)


def test_batch_shardings_split_rows():
    batch = {"tokens": torch.zeros((512, 65), dtype=torch.int32),
             "weights": torch.zeros((512, 64))}
    specs = _specs(batch_shardings(MESH2, RULES, batch))
    assert specs == {"['tokens']": (("pod", "data"),),
                     "['weights']": (("pod", "data"),)}
    sp = ShardingRules(sp=True)
    assert _specs(batch_shardings(MESH1, sp, batch))["['weights']"] == \
        ("data", "model")
    odd = {"tokens": torch.zeros((3, 65), dtype=torch.int32)}
    assert _specs(batch_shardings(MESH1, RULES, odd)) == {"['tokens']": ()}


def test_activate_and_constrain():
    """``activate`` keeps the rules in force; ``constrain`` is the
    identity on the port's whole per-rank tensors."""
    x = torch.randn(4, 8, 16)
    assert active() is None
    with activate(MESH1, RULES) as ctx:
        assert active() == ctx.entry == (MESH1, RULES.table(MESH1))
        with activate(MESH2, ShardingRules(fsdp=False)):
            assert active()[0] is MESH2
        assert active()[0] is MESH1
        assert constrain(x, ("batch", "seq", None)) is x
    assert active() is None


def test_param_axes_follow_the_head():
    """``param_axes`` keeps ``init``'s keys for each head (MACH, untied and
    tied OAA) and names the MACH kernel's dims (embed, mach_rb)."""
    base = get_config("recurrentgemma-2b", smoke=True)
    assert base.mach is not None
    for cfg in (base, dataclasses.replace(base, mach=None,
                                          tie_embeddings=False),
                dataclasses.replace(base, mach=None, tie_embeddings=True)):
        model = LanguageModel(cfg)
        assert set(model.param_axes()) == set(model.init(device="meta"))
    assert LanguageModel(base).param_axes()["mach_head"] == \
        {"kernel": ("embed", "mach_rb")}


def _local_bytes(mesh, x, sharding) -> int:
    """A rank's bytes of leaf ``x`` placed by ``sharding``: each dim over
    the product of its spec entry's mesh axes."""
    from repro_torch.sharding.partitioning import spec_axes
    dims = list(x.shape)
    for d, entry in enumerate(sharding.spec):
        split = int(np.prod([mesh.shape[a] for a in spec_axes(entry)]))
        assert dims[d] % split == 0
        dims[d] //= split
    return int(np.prod(dims)) * x.element_size()


@pytest.mark.parametrize("arch,per_rank", [
    ("tinyllama-1.1b", 55_292_160), ("mistral-large-123b", 6_080_478_720)])
def test_production_mesh_sizes_under_fsdp(arch, per_rank):
    """The full config (MACH head, bf16 params, AdamW's float32 moments)
    drawn on the meta device and placed by ``state_shardings`` on the
    (16, 16) mesh with the FSDP rules.  A rank holds ``per_rank`` bytes
    of the state; a sharded step holds besides at most the leaves outside
    the layer stacks and two periods whole (``partitioning.materialize``
    gathers each period where it runs), where gathering the whole tree
    held every param.  mistral-large-123b then fits one 80 GB card; with
    the whole tree it did not."""
    from repro_torch.checkpoint import tree_flatten
    from repro_torch.train.trainer import (TrainConfig,
                                           make_optimizer_from_config)
    cfg = get_config(arch, mach="on")
    opt, _ = make_optimizer_from_config(TrainConfig())
    shapes, shardings, _ = state_shardings(MESH1, RULES, LanguageModel(cfg),
                                           opt)
    leaves = [(x, s) for (_, x), (_, s) in zip(tree_flatten(shapes),
                                               tree_flatten(shardings))
              if isinstance(x, torch.Tensor)]
    got = sum(_local_bytes(MESH1, x, s) for x, s in leaves)
    whole = sum(x.numel() * x.element_size() for x, _ in leaves)
    assert got == per_rank and whole / 256 <= got < whole / 100

    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    heads = 2 * cfg.num_heads + 2 * cfg.num_kv_heads
    period = 2 * (d * hd * heads + 3 * d * f + 2 * d)        # bf16, swiglu
    rest = 2 * (cfg.vocab_size * d + d * cfg.mach.num_repetitions
                * cfg.mach.num_buckets + d)       # embed, MACH head, norm
    params = shapes.params
    nbytes = lambda t: sum(x.numel() * x.element_size()       # noqa: E731
                           for _, x in tree_flatten(t))
    assert [nbytes(p) // cfg.num_layers for p in params["stacks"]] == [period]
    assert nbytes({k: v for k, v in params.items() if k != "stacks"}) == rest
    per_period, whole_tree = got + rest + 2 * period, got + nbytes(params)
    if arch == "mistral-large-123b":
        assert period == 2_768_289_792 and rest == 1_207_984_128
        assert per_period < 80e9 < whole_tree
    else:
        assert period == 88_088_576 and rest == 198_184_960
        assert per_period < whole_tree / 5


# an NVIDIA H100 node: 8 cards on NVLink as one model-parallel group
H100_NODE = FakeMesh({"data": 1, "model": 8})
HEAD_MESHES = {"16x16": (MESH1, RULES), "2x16x16": (MESH2, RULES),
               "2x16x16_pod_parallel": (
                   MESH2, ShardingRules(mach_pod_parallel=True)),
               "1x8": (H100_NODE, RULES)}


@pytest.mark.parametrize("mesh_name", list(HEAD_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mach_head_splits_by_repetition_where_it_divides(arch, mesh_name):
    """Every config's MACH head (``mach="on"``: R = 8, B = 2,048, bf16)
    placed by the rules (held to JAX's spec): whether the mesh axes that
    split its R·B columns, n ranks, divide R (``repetition_shards``), and
    the head bytes a rank gathers in a step, d·R·B·2 / n where it splits,
    else the whole d·R·B·2.  On (16, 16) and (2, 16, 16), with or without
    ``mach_pod_parallel``, n is 16 or 32 > R = 8: no config splits.  On
    an 8-card H100 node, (1, 8), each rank owns one repetition:
    tinyllama-1.1b's 67,108,864-byte head is 8,388,608 a rank."""
    from repro_torch.sharding import repetition_shards
    mesh, rules = HEAD_MESHES[mesh_name]
    cfg = get_config(arch, mach="on")
    r, b, d = cfg.mach.num_repetitions, cfg.mach.num_buckets, cfg.d_model
    spec = _spec(mesh, ("embed", "mach_rb"), (d, r * b), rules)
    cols = spec[1] if len(spec) > 1 else None
    n = repetition_shards(mesh, cols, r)
    whole = d * r * b * 2
    if mesh_name == "1x8":
        assert cols == "model" and n == 8
    else:
        assert n is None
        assert cols == (("pod", "model") if "pod_parallel" in mesh_name
                        else "model")
    gathered = whole // n if n else whole
    assert gathered == {"1x8": d * b * 2}.get(mesh_name, whole)
    if arch == "tinyllama-1.1b":
        assert whole == 67_108_864
        assert gathered == (8_388_608 if n else whole)


SPLIT_MESHES = {"1x8": H100_NODE, "16x16": MESH1}


def _dims(spec, ndim: int) -> tuple:
    """A stacked leaf's spec as ``dim_axes`` reads a ``DTensor``: the mesh
    axes of each tensor dim, the stacked layer dim left out."""
    from repro_torch.sharding.partitioning import spec_axes
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(spec_axes(e) for e in entries[1:])


@pytest.mark.parametrize("mesh_name", list(SPLIT_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decoder_splits_where_the_rules_divide(arch, mesh_name):
    """Every full config's decoder (and encoder) blocks placed by the
    rules on an 8-card node (1, 8) and on (16, 16): ``split_plan`` of
    each block's attention and MLP layouts splits the attention over
    ``model`` exactly where n = |model| divides H, with k and v split too
    where n divides KV (else replicated, each rank cutting its kv heads,
    where its H/n heads hold whole GQA groups or lie inside one), and
    the MLP where n divides d_ff.  tinyllama-1.1b on (1, 8) splits
    heads and MLP and keeps its 4 kv heads whole; recurrentgemma-2b keeps
    its 10 heads whole and splits d_ff 7,680 on both; paligemma-3b's 8
    heads split on (1, 8) and not on (16, 16), its d_ff 16,384 on both;
    xlstm-350m has no block that splits."""
    from repro_torch.sharding import split_plan
    mesh = SPLIT_MESHES[mesh_name]
    cfg = get_config(arch)
    model = LanguageModel(cfg)
    shapes = model.init(device="meta")
    shard = params_shardings(mesh, RULES, model.param_axes(), shapes)
    n = mesh.shape["model"]
    plans = []
    for key in ("stacks", "enc_stacks"):
        for blocks, specs in zip(shapes.get(key, []), shard.get(key, [])):
            for block, spec in zip(blocks, specs):
                parts = {part: {name: _dims(spec[part][name]["kernel"].spec,
                                            leaf["kernel"].dim())
                                for name, leaf in block[part].items()}
                         for part in ("attn", "mlp") if part in block}
                if not parts:
                    continue
                plan = split_plan(mesh, parts.get("attn"), parts.get("mlp"),
                                  cfg.num_heads, cfg.num_kv_heads)
                per, g = cfg.num_heads // n, cfg.num_heads // cfg.num_kv_heads
                heads = "attn" in parts and cfg.num_heads % n == 0 and (
                    cfg.num_kv_heads % n == 0 or per % g == 0 or g % per == 0)
                want = (("model",) if heads else (),
                        heads and cfg.num_kv_heads % n == 0,
                        ("model",) if "mlp" in parts and cfg.d_ff % n == 0
                        else ())
                assert plan == want, (key, plan, want)
                plans.append(plan)
    assert bool(plans) == (arch != "xlstm-350m")
    split_all = (("model",), False, ("model",))
    examples = {("tinyllama-1.1b", "1x8"): {split_all},
                ("recurrentgemma-2b", "1x8"): {((), False, ("model",))},
                ("recurrentgemma-2b", "16x16"): {((), False, ("model",))},
                ("paligemma-3b", "1x8"): {split_all},
                ("paligemma-3b", "16x16"): {((), False, ("model",))}}
    if (arch, mesh_name) in examples:
        assert set(plans) == examples[(arch, mesh_name)]


# an RG-LRU block's channels and an ``xattn`` block's cross-attention
# query heads a rank by mesh, where they split (3 ``model`` ranks divide
# neither)
WIDE_MESHES = dict(SPLIT_MESHES, **{"1x3": FakeMesh({"data": 1, "model": 3})})
WIDE_SPLITS = {("recurrentgemma-2b", "1x8"): ("rglru", 320),
               ("recurrentgemma-2b", "16x16"): ("rglru", 160),
               ("seamless-m4t-large-v2", "1x8"): ("xattn", 2),
               ("seamless-m4t-large-v2", "16x16"): ("xattn", 1)}


def _tree_dims(spec_tree, shape_tree):
    """``_dims`` of every leaf of a block part's spec tree."""
    if isinstance(shape_tree, dict):
        return {k: _tree_dims(spec_tree[k], v) for k, v in shape_tree.items()}
    return _dims(spec_tree.spec, shape_tree.dim())


@pytest.mark.parametrize("mesh_name", list(WIDE_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rglru_and_cross_attention_split_where_the_rules_divide(arch,
                                                                mesh_name):
    """Every full config's blocks placed by the rules on (1, 8), (16,
    16) and (1, 3): ``rglru_plan`` splits an RG-LRU block over ``model``
    exactly where n = |model| divides its width W (every leaf's channel
    dim on ``model``, gate_a's and gate_x's rows only), and
    ``split_plan`` an ``xattn`` block's cross-attention where n divides
    H, its K/V with it where n divides KV; recurrentgemma-2b's 2,560
    channels split 320 and 160 a rank on (1, 8) and (16, 16),
    seamless-m4t-large-v2's 16 cross heads (KV 16) 2 and 1 a rank; on
    (1, 3) neither splits."""
    from repro_torch.sharding import rglru_plan, split_plan
    mesh = WIDE_MESHES[mesh_name]
    cfg = get_config(arch)
    model = LanguageModel(cfg)
    shapes = model.init(device="meta")
    shard = params_shardings(mesh, RULES, model.param_axes(), shapes)
    n = mesh.shape["model"]
    w, h, kv = cfg.resolved_rnn_width, cfg.num_heads, cfg.num_kv_heads
    seen = set()
    for blocks, specs in zip(shapes["stacks"], shard["stacks"]):
        for block, spec in zip(blocks, specs):
            if "rglru" in block:
                dims = _tree_dims(spec["rglru"], block["rglru"])
                want = ("model",) if w % n == 0 else ()
                assert rglru_plan(dims) == want, (dims, want)
                gate = dims["gate_a"]["kernel"]
                assert gate[1] == () and gate[0] == want
                if want:
                    seen.add(("rglru", w // n))
            if "xattn" in block:
                dims = {name: _dims(spec["xattn"][name]["kernel"].spec,
                                    leaf["kernel"].dim())
                        for name, leaf in block["xattn"].items()}
                heads = h % n == 0
                plan = split_plan(mesh, dims, None, h, kv)
                assert plan == (("model",) if heads else (),
                                heads and kv % n == 0, ()), plan
                if heads:
                    seen.add(("xattn", h // n))
    want = WIDE_SPLITS.get((arch, mesh_name))
    assert seen == ({want} if want else set()), seen


# (arch, mesh) -> how the experts split (``expert_plan``) and the range
# a rank owns of the split dim: experts on (1, 8) where 8 divides E, else
# every expert's d_ff columns
MOE_SPLITS = {("mixtral-8x22b", "1x8"): ("experts", 1),
              ("mixtral-8x22b", "16x16"): ("columns", 1024),
              ("qwen2-moe-a2.7b", "1x8"): ("columns", 176),
              ("qwen2-moe-a2.7b", "16x16"): ("columns", 88)}
# one layer's routed experts (wi, wg, wo), bf16 bytes: whole, and what a
# rank gathers (its shards kept on ``model``) by mesh
MOE_LAYER_BYTES = {"mixtral-8x22b": (4_831_838_208, {"1x8": 603_979_776,
                                                     "16x16": 301_989_888}),
                   "qwen2-moe-a2.7b": (1_038_090_240,
                                       {"1x8": 129_761_280,
                                        "16x16": 64_880_640})}


@pytest.mark.parametrize("mesh_name", list(SPLIT_MESHES))
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen2-moe-a2.7b"])
def test_moe_splits_where_the_rules_divide(arch, mesh_name):
    """The full MoE configs' blocks placed by the rules (held to JAX's
    spec by ``test_every_param_spec_matches_jax``) on an 8-card node
    (1, 8) and on (16, 16): ``expert_plan`` of the expert kernels' layouts
    splits by expert where n = |model| divides E (mixtral's 8 experts on
    (1, 8), one a rank), else by columns where n divides d_ff (mixtral's
    16,384 on (16, 16), 1,024 a rank; qwen2-moe's 60 experts divide by
    neither 8 nor 16, so its 1,408 columns split, 176 and 88 a rank);
    the shared experts' MLP by columns (qwen2-moe's 5,632: 704 and 352 a
    rank); the router and ``shared_gate`` never on ``model``.  One
    layer's experts are 4.83 GB (mixtral) and 1.04 GB (qwen2-moe) in
    bf16; a rank gathers 1/n of them."""
    from repro_torch.sharding import expert_plan, split_plan
    from repro_torch.sharding.partitioning import spec_axes
    mesh = SPLIT_MESHES[mesh_name]
    cfg = get_config(arch)
    model = LanguageModel(cfg)
    shapes = model.init(device="meta")
    shard = params_shardings(mesh, RULES, model.param_axes(), shapes)
    n = mesh.shape["model"]
    e, f, fs = cfg.num_experts, cfg.moe_d_ff, cfg.shared_d_ff
    mode, per = MOE_SPLITS[(arch, mesh_name)]
    assert mode == ("experts" if e % n == 0 else "columns")
    assert per == (e if mode == "experts" else f) // n
    whole, by_mesh = MOE_LAYER_BYTES[arch]
    blocks = 0
    for p_list, s_list in zip(shapes["stacks"], shard["stacks"]):
        for block, spec in zip(p_list, s_list):
            moe, ms = block["moe"], spec["moe"]
            names = [k for k in ("wi", "wg", "wo") if k in moe]
            layouts = {k: _dims(ms[k]["kernel"].spec, moe[k]["kernel"].dim())
                       for k in names}
            assert expert_plan(layouts) == (mode, ("model",)), layouts
            for key in ("router", "shared_gate"):
                if key in ms:
                    assert all("model" not in spec_axes(entry)
                               for entry in ms[key]["kernel"].spec), key
            if fs:
                shared = {k: _dims(ms["shared"][k]["kernel"].spec,
                                   moe["shared"][k]["kernel"].dim())
                          for k in moe["shared"]}
                assert split_plan(mesh, None, shared, 1, 1)[2] == \
                    (("model",) if fs % n == 0 else ())
                assert fs // n == {8: 704, 16: 352}[n]
            nbytes = [moe[k]["kernel"].numel() // moe[k]["kernel"].shape[0]
                      * moe[k]["kernel"].element_size() for k in names]
            assert sum(nbytes) == whole
            kept = 0
            for k, size in zip(names, nbytes):
                split = {a for entry in ms[k]["kernel"].spec
                         for a in spec_axes(entry)}
                kept += size // n if "model" in split else size
            assert kept == by_mesh[mesh_name] == whole // n
            blocks += moe["wi"]["kernel"].shape[0]       # stacked layers
    assert blocks == cfg.num_layers
    # the rules put E on ``model`` only where n divides it
    assert expert_plan(None) == ("", ())


@pytest.mark.parametrize("h,g", [(32, 1), (32, 4), (32, 8), (32, 32),
                                 (96, 12), (24, 3)])
def test_kv_heads_of_each_rank(h, g):
    """H query heads in groups of G (tinyllama's G = 8, mistral-large's
    12, MHA's 1, MQA's 32), on every n dividing H, with k and v
    replicated on ``model``: where a rank's H/n heads hold whole groups
    or lie inside one, ``split_plan`` splits the attention and rank k's
    query heads [k·H/n, (k+1)·H/n) are handed the kv heads [k0, k1) of
    ``kv_heads``, grouped as the kernels group them (local query head j
    reads local kv head j // (H/n / (k1 - k0))), each the kv head i // G
    of its global head i.  Where they straddle a group (G = 12 and G = 3
    at n = 3, 6 and 12) ``split_plan`` keeps the attention whole and
    ``kv_heads`` refuses the range."""
    from repro_torch.sharding import kv_heads, split_plan
    kv = h // g
    replicated = {"q": ((), ("model",), ()), "o": (("model",), (), ()),
                  "k": ((), (), ()), "v": ((), (), ())}
    straddled = []
    for n in (d for d in range(1, h + 1) if h % d == 0):
        per = h // n
        plan = split_plan(FakeMesh({"data": 1, "model": n}), replicated,
                          None, h, kv)
        if per % g and g % per:
            straddled.append(n)
            assert plan == ((), False, ()), (n, plan)
            with pytest.raises(ValueError):
                kv_heads(0, per, h, kv)
            continue
        assert plan == (("model",), False, ()), (n, plan)
        for k in range(n):
            k0, k1 = kv_heads(k * per, (k + 1) * per, h, kv)
            assert per % (k1 - k0) == 0, (n, k, k0, k1)
            group = per // (k1 - k0)
            assert all(k0 + j // group == (k * per + j) // g
                       for j in range(per)), (n, k, k0, k1)
    assert straddled == ([3, 6, 12] if g in (3, 12) else []), straddled

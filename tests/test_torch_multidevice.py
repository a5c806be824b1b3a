"""Multi-device training on CPU ``gloo`` worlds of 2 and 4 processes
(``torch_multidevice_ranks.py`` is the rank side), held against the
single-device port on the same global batches, and the world-2
checkpoint held against the unsharded port and the JAX package's
``CheckpointManager``.  The sharded step gathers each param where the
model uses it (``partitioning.materialize``), a layer period at a time:
the worlds count the gathered bytes alive at once against the leaves
outside the layer stacks plus two periods.  The smoke configs run with
``remat="full"`` and at least 4 layers (``model_config``).  The smoke
tinyllama with a MACH head (``mach_model_config``: R = 4, B = 16) holds
the head split by repetition and the bucket selection under a mesh.
Where ``model`` has more than one rank the decoder splits by heads and
hidden (``partitioning.block_split``): (1, 2), (1, 4) and (2, 2) with
the smoke tinyllama, with and without its MACH head, (2, 1, 2) with
``mach_pod_parallel``, (1, 2) in bf16 and with recurrentgemma-2b, each
rank's heads, columns and gathered bytes counted (``SplitCount``).

Each world is spawned once (module fixtures) and runs every check
inside; the tests read what its rank 0 wrote.  The worlds join by a
deadline and kill what is left, so a hang fails here.

Tolerances.  Float32 (smoke configs, params and activations float32):
every metric of every step (loss, tokens, grad_norm, lr, the MoE aux
losses) at rtol 1e-6; the params after the steps within 1e-6 of each
leaf's largest entry, except at most 0.01% of the entries, which lie
within 2·Σlr — Adam divides a first moment by the root of the second,
so a weight gradient that cancels to float32 noise (summed in another
order over two ranks) takes an update of about lr whose sign the noise
picks (as in ``test_torch_lm_train.py``).  xlstm-350m's share is at
most 0.1%: its sLSTM input-gate bias has a gradient of float32 noise
(at most 2e-9 at init, against 1e-2 to 1e-1 for its other leaves), so
Adam makes each of its 128 entries an update the noise sets, and its
zero-initialised LayerNorm and gate biases hold after two steps only
Adam's updates, so 1e-6 of their largest entry is ~1e-9 (0.073%
measured on two steps, every entry within 2·Σlr).  A split decoder
sums its blocks' partial outputs over the ``model`` ranks, which moves
each block's output by about a float32 ulp; the same ulp added to every
block's output on one device already puts 0.0086% of the smoke
tinyllama's entries, 0.0112% of the same with its MACH head (0.0101%
fused) and 0.0234% of recurrentgemma-2b's past 1e-6 of their leaf's
largest (``tools/split_noise_floor.py``).  So the cases whose floor
lies above 0.01% are held at twice it, rounded up: the MACH head's
split cases, whose decoder splits too, at 0.025% (``MACH_OFF_SHARE``),
recurrentgemma-2b's split case at 0.05% (``RG_OFF_SHARE``).
bf16 (params and activations): the first step's loss at rtol 1e-6 (rows
are independent until the loss's float32 sums), the gradient norm and
later metrics at rtol 2^-6, the params within 2·Σlr: the ranks' bf16
gradients are rounded, then summed in bf16.  With the decoder split the
first loss too is held at rtol 2^-6: the partial outputs are rounded to
bf16, then summed in bf16.
World size 1 is bit for bit (``test_torch_cuda.py`` on the card).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro_torch.checkpoint import CheckpointManager, tree_flatten
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import LanguageModel
from repro_torch.train import Trainer
from torch_multidevice_ranks import (model_config, spawn_world,
                                     train_config)

RTOL = 1e-6
BF16_RTOL = 2.0 ** -6
OFF_SHARE = 1e-4
XLSTM_OFF_SHARE = 1e-3
MACH_OFF_SHARE = 2.5e-4
RG_OFF_SHARE = 5e-4
WORLD_TIMEOUT = 240


@pytest.fixture(scope="module")
def directory(tmp_path_factory):
    return str(tmp_path_factory.mktemp("multidevice"))


@pytest.fixture(scope="module")
def world2(directory):
    return spawn_world(2, "world2", directory, WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world4(world2, directory):
    return spawn_world(4, "world4", directory, WORLD_TIMEOUT)


def _leaves(tree):
    return [x for _, x in tree_flatten(tree)]


def _hold(res, bf16=False, split=False):
    """``res``: per step (sharded, one device) metrics, and both final
    params.  Returns the share of param entries off by more than rtol of
    their leaf's largest entry.  ``split``: a bf16 run whose decoder
    splits, whose first loss is held at the bf16 rtol too."""
    lr_sum = sum(rm["lr"] for _, rm in res["metrics"])
    first = ("tokens", "lr") if split else ("loss", "tokens", "lr")
    for step, (got, want) in enumerate(res["metrics"]):
        assert set(got) == set(want)
        for k in want:
            exact = not bf16 or (step == 0 and k in first)
            rtol = RTOL if exact else BF16_RTOL
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=f"step {step} {k}")
    off = total = 0
    for got, want in zip(_leaves(res["params"]), _leaves(res["want"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        err = (got.float() - want.float()).abs()
        assert float(err.max()) <= 2 * lr_sum
        off += int((err > RTOL * float(want.float().abs().max())).sum())
        total += err.numel()
    return off / total


@pytest.mark.parametrize("case", ["adamw", "adafactor", "weighted",
                                  "microbatches", "moe", "fused", "xlstm",
                                  "encdec", "vision"])
def test_world2_matches_one_device(world2, case):
    """Mesh (2, 1): three AdamW steps of the smoke tinyllama-1.1b, one
    Adafactor step, uneven weights (rank 0's rows keep ~20% of their
    tokens, rank 1's ~90%), two microbatches, the smoke qwen2-moe-a2.7b
    (groups of 16 whole on each rank), recurrentgemma-2b with the fused
    MACH loss (kernel 4's plain version), xlstm-350m (mLSTM and sLSTM
    blocks), seamless-m4t-large-v2 (the encoder's adapter, stacks and
    norm, the cross-attention K/V of every decoder layer) and
    paligemma-3b (the vision adapter)."""
    share = _hold(world2[case])
    bound = {"adafactor": 0, "xlstm": XLSTM_OFF_SHARE}.get(case, OFF_SHARE)
    assert share <= bound, share


def test_world2_uneven_weights_are_the_global_mean(world2):
    first = world2["weighted"]["metrics"][0][1]
    assert first["tokens"] < 64 * 0.7        # the halves' sums differ


def test_world2_bf16_within_its_tolerance(world2):
    _hold(world2["bf16"], bf16=True)


@pytest.mark.parametrize("mesh", ["mesh4x1", "mesh2x2", "pod",
                                  "mesh4x1_microbatches"])
def test_world4_matches_one_device(world4, mesh):
    """Meshes (4, 1), (2, 2) (the batch over data, replicas on model),
    (2, 2, 1) with a pod axis (the batch over (pod, data)), and (4, 1)
    with two microbatches and uneven weights."""
    assert _hold(world4[mesh]) <= OFF_SHARE


@pytest.mark.parametrize("world,case", [
    ("world2", "adamw"), ("world2", "microbatches"), ("world4", "mesh4x1"),
    ("world4", "mesh2x2"), ("world4", "mesh4x1_microbatches")])
def test_gathered_bytes_stay_within_two_periods(request, world, case):
    """The sharded tinyllama steps' gathered bytes alive at once (a
    ``GatherCount`` around ``partitioning.materialize``) stay within the
    leaves outside the layer stacks plus two periods, below the whole
    tree; with and without two microbatches."""
    g = request.getfixturevalue(world)[case]["gathered"]
    assert g["calls"] > 0
    assert g["peak"] <= g["bound"] < g["whole"], g


@pytest.mark.parametrize("world,optimizer", [
    ("world2", "adamw"), ("world2", "master"), ("world2", "adafactor"),
    ("world4", "adamw")])
def test_init_places_params_before_the_optimizer_state(request, world,
                                                       optimizer):
    """``Trainer.init_state`` builds the optimizer state on the placed
    params: every leaf a ``DTensor`` equal, shard for shard, to placing a
    whole drawn state (AdamW, AdamW with master weights, Adafactor's
    factored moments; meshes (2, 1) and (2, 2))."""
    same = request.getfixturevalue(world)["init"][optimizer]
    assert same and all(same), same


def test_sharded_step_never_gathers_the_whole_tree(world2):
    """Two sharded steps: ``partitioning.gather`` never runs, and
    ``full_tensor`` makes only the metrics and the gradient norm whole;
    ``DataParallel`` has no whole-tree gradient reduction."""
    from repro_torch.train.trainer import DataParallel
    seen = world2["collectives"]
    assert seen["gather"] == 0
    assert seen["full_tensor"] and all(
        int(np.prod(shape)) <= 16 for shape in seen["full_tensor"]), seen
    assert not hasattr(DataParallel, "reduce_grads")


@pytest.mark.parametrize("case", ["remat", "no_remat", "microbatches",
                                  "bf16", "fused", "selected"])
def test_single_device_step_bits_unchanged(case, monkeypatch):
    """On one device ``materialize`` hands back its argument, so a step
    is bit for bit the step of a model without the gathers: losses,
    metrics, params and moments after two steps (remat on and off, two
    microbatches, bf16 with master weights, a MACH head with the fused
    loss, and with its in-loss bucket selection)."""
    import dataclasses
    from repro_torch.sharding import partitioning
    from torch_multidevice_ranks import batches, mach_model_config
    cfg = model_config("tinyllama-1.1b")
    tc = train_config(num_microbatches=2 if case == "microbatches" else 1)
    if case == "no_remat":
        cfg = dataclasses.replace(cfg, remat="none")
    if case == "bf16":
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16,
                                  param_dtype=torch.bfloat16)
        tc = train_config(master_weights=True)
    if case in ("fused", "selected"):
        cfg = mach_model_config(mach_fused_loss=True, mach_bucket_select=(
            12, 1) if case == "selected" else None)
    data = batches(cfg, 2, weighted=True)

    def run():
        trainer = Trainer(LanguageModel(cfg), tc)
        state = trainer.init_state(torch.Generator().manual_seed(0), "cpu")
        metrics = []
        for b in data:
            state, m = trainer.step_fn(state, b)
            metrics.append(m)
        return state, metrics

    tree = {"a": torch.ones(2), "b": [torch.zeros(3)]}
    assert partitioning.materialize(tree) is tree
    got = run()
    monkeypatch.setattr(partitioning, "materialize", lambda t: t)
    want = run()
    for (path, g), (_, w) in zip(tree_flatten(got), tree_flatten(want)):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), path
        else:
            assert g == w, path


@pytest.mark.parametrize("n", [2, 4])
def test_head_on_a_repetition_range(n):
    """``MACHOutputHead.apply`` and ``fused_loss`` on a rank's columns
    (``reps`` = (r0, r1)): the logits are the whole head's repetitions
    [r0, r1); the weighted mean losses of the n ranges sum to the whole
    head's at float32 rtol 1e-6."""
    from repro_torch.configs import default_mach_head
    from repro_torch.core.mach import MACHOutputHead
    head = MACHOutputHead(default_mach_head(256, "on", num_buckets=16,
                                            num_repetitions=4), 64)
    gen = torch.Generator().manual_seed(n)
    params = head.init(gen, "cpu")
    h = torch.randn((3, 5, 64), generator=gen)
    labels = torch.randint(0, 256, (3, 5), generator=gen)
    weights = (torch.rand((3, 5), generator=gen) < 0.7).float()
    whole = head.apply(params, h)
    total = torch.zeros(())
    per = 4 // n
    for k in range(n):
        r0, r1 = k * per, (k + 1) * per
        part = {"kernel": params["kernel"][:, r0 * 16:r1 * 16]}
        assert torch.equal(head.apply(part, h, (r0, r1)),
                           whole[..., r0:r1, :])
        total = total + head.fused_loss(part, h, labels, weights,
                                        reps=(r0, r1))
    torch.testing.assert_close(total, head.fused_loss(params, h, labels,
                                                      weights),
                               rtol=1e-6, atol=0)


# the MACH head split by repetition: (world, case) -> the mesh axes that
# split its columns (none where they do not divide R: the head gathered)
HEAD_CASES = {
    ("world2", "split12"): ("model",), ("world2", "split12_fused"): ("model",),
    ("world2", "r3"): (), ("world2", "select12"): ("model",),
    ("world4", "split22"): ("model",), ("world4", "split22_fused"): ("model",),
    ("world4", "split14"): ("model",), ("world4", "split14_fused"): ("model",),
    ("world4", "pod_split"): ("pod", "model"),
    ("world4", "pod_split_fused"): ("pod", "model"),
    ("world4", "select22"): ("model",)}


@pytest.mark.parametrize("world,case", list(HEAD_CASES))
def test_head_split_matches_one_device(request, world, case):
    """The smoke tinyllama with a MACH head (R = 4, B = 16; R = 3 in
    ``r3``) through the sharded step, each rank computing its own
    repetitions, against one device: meshes (1, 2), (2, 2), (1, 4) and
    (2, 1, 2) with ``mach_pod_parallel``, unfused (kernel 3's plain
    version) and fused (kernel 4's); ``r3`` takes the gathered head;
    ``select*`` the fused loss over the in-loss bucket selection.  The
    decoder splits by heads and hidden on ``model`` in every case, so
    each is held at ``MACH_OFF_SHARE``."""
    share = _hold(request.getfixturevalue(world)[case])
    assert share <= MACH_OFF_SHARE, share


@pytest.mark.parametrize("world,case", list(HEAD_CASES))
def test_head_split_gathers_and_computes_its_repetitions(request, world,
                                                         case):
    """Counted around the step (``HeadCount``): rank k of the n ranks on
    the axes that split the head's columns (major first) takes
    repetitions [k·R/n, (k+1)·R/n), as ``repetition_range`` of its head
    leaf says (None for R = 3 on two ranks); the head is gathered over the other
    axes only, d·R·B/n float32 bytes; every kernel call (``ops.mach_xent``,
    or ``ops.mach_fused_xent`` on the fused paths) sees R/n repetitions.
    R = 3 on two ``model`` ranks: n = 1, the head gathered whole."""
    res = request.getfixturevalue(world)[case]
    axes = HEAD_CASES[(world, case)]
    r = 3 if case == "r3" else 4
    d, b = 64, 16
    n = int(np.prod([res["shape"][a] for a in axes]))
    per = r // n
    fused = case.endswith("_fused") or case.startswith("select")
    names = list(res["shape"])
    for rank in res["head"]:
        k = 0
        for a in axes:
            k = k * res["shape"][a] + rank["coord"][names.index(a)]
        assert rank["splits"] and \
            set(rank["splits"]) == {(k * per, (k + 1) * per, axes)}, rank
        assert rank["range"] == ((k * per, (k + 1) * per) if axes
                                 else None), rank
        assert rank["gathers"] and \
            set(rank["gathers"]) == {((d, per * b), d * per * b * 4)}, rank
        used, unused = (rank["fused"], rank["xent"]) if fused else \
            (rank["xent"], rank["fused"])
        assert used and set(used) == {per} and not unused, rank


@pytest.mark.parametrize("world,case", [("world2", "select12"),
                                        ("world4", "select22")])
def test_selection_under_a_mesh_is_the_global_one(request, world, case):
    """``mach_bucket_select=(12, 1)`` under a mesh ((1, 2) and (2, 2)),
    the decoder split too: each rank's selected bucket ids, every step,
    equal its rows of one device's selection exactly.  The gap between each repetition's 12th
    and 13th boosted proxy score on one device (printed) lies above what
    float32 reassociation can move: (N + d + 2)·eps·max((mean |h|) @ |W|)
    for the proxy, eps·(span + max |proxy|) for the boost, twice (both
    scores)."""
    res = request.getfixturevalue(world)[case]
    eps = float(torch.finfo(torch.float32).eps)
    steps = len(res["one"])
    assert steps == 2 and len(res["one_proxies"]) == steps
    for step, ((proxy, labels, sel), (n, d, scale)) in enumerate(
            zip(res["one"], res["one_proxies"])):
        c_sel = sel.shape[1]
        lbl = labels.reshape(-1, labels.shape[-1]).long()
        present = torch.zeros_like(proxy)
        present[torch.arange(proxy.shape[0]).expand(lbl.shape), lbl] = 1.0
        span = proxy.max() - proxy.min() + 1.0
        ranked = torch.sort(proxy + present * span, dim=-1,
                            descending=True).values
        gaps = (ranked[:, c_sel - 1] - ranked[:, c_sel]).tolist()
        tol = 2 * ((n + d + 2) * eps * scale
                   + eps * float(span + proxy.abs().max()))
        print(f"{world} {case} step {step}: gaps between the {c_sel}th and "
              f"{c_sel + 1}th scores by repetition {gaps}; reassociation "
              f"bound {tol:.3e}; label buckets {present.sum(1).tolist()}")
        assert min(gaps) > tol
        # the label buckets leave room in the selection: the boost decides
        assert float(present.sum(1).min()) < c_sel
        for rank in res["head"]:
            r0, r1, _ = rank["splits"][step]
            assert torch.equal(rank["selected"][step], sel[r0:r1]), \
                (step, rank["coord"])


# the decoder split by heads and hidden on ``model``: (world, case) -> arch
DECODER_CASES = {("world2", "tp12"): "tinyllama-1.1b",
                 ("world2", "tp12_bf16"): "tinyllama-1.1b",
                 ("world2", "tp12_rg"): "recurrentgemma-2b",
                 ("world4", "mesh2x2"): "tinyllama-1.1b",
                 ("world4", "tp14"): "tinyllama-1.1b"} | {
                     case: "tinyllama-1.1b" for case in HEAD_CASES}
# the float32 smoke tinyllama's gathered bytes of one period a rank, by
# the ranks on ``model`` (k and v split at 2, cut from the whole at 4)
PERIOD_BYTES = {1: 176_640, 2: 88_576, 4: 50_688}


@pytest.mark.parametrize("world,case", [("world2", "tp12"),
                                        ("world2", "tp12_rg"),
                                        ("world4", "tp14")])
def test_decoder_split_matches_one_device(request, world, case):
    """The smoke tinyllama with its decoder split on (1, 2) (each rank
    its 4 query heads, its kv head and 88 MLP columns) and on (1, 4) (2
    query heads, the kv head they read cut from the whole k and v, 44
    columns), and recurrentgemma-2b on (1, 2), against one device ((2, 2)
    is ``mesh2x2`` above, and the MACH head's cases split the decoder
    too).  recurrentgemma-2b at its own share
    (``RG_OFF_SHARE``)."""
    bound = RG_OFF_SHARE if case == "tp12_rg" else OFF_SHARE
    assert _hold(request.getfixturevalue(world)[case]) <= bound


def test_decoder_split_bf16_within_its_tolerance(world2):
    """The bf16 smoke tinyllama with its decoder split on (1, 2): every
    metric, the first loss too, at rtol 2^-6, the params within 2·Σlr
    (the partial outputs are rounded to bf16, then summed in bf16)."""
    _hold(world2["tp12_bf16"], bf16=True, split=True)


def _period_leaves(params) -> dict:
    """Per stacked period, by its number of blocks: each block's leaves'
    (shape less the layer dim, bytes an entry), by path."""
    return {len(p_list): [{path: (tuple(x.shape[1:]), x.element_size())
                           for path, x in tree_flatten(block)}
                          for block in p_list]
            for p_list in params["stacks"]}


def _local_shape(path, shape, split, n):
    """A leaf's shape on a rank of n whose block splits as ``split``."""
    attn, kv, mlp = split or (None, None, None)
    shape = list(shape)
    if attn and path.startswith("['attn']"):
        if "['q']" in path or ("['o']" not in path and kv is None):
            shape[1] //= n                       # q, and k / v split
        elif "['o']" in path:
            shape[0] //= n
    if mlp and path.startswith("['mlp']"):
        shape[0 if "['wo']" in path else -1] //= n
    return tuple(shape)


@pytest.mark.parametrize("world,case", list(DECODER_CASES))
def test_decoder_split_computes_its_heads_and_columns(request, world, case):
    """Counted around the sharded steps (``SplitCount``): rank k of the n
    ``model`` ranks splits every block with self-attention on query
    heads [k·H/n, (k+1)·H/n), its k and v split with them where n
    divides KV and else cut to the kv heads they read, and every block
    with an MLP on columns [k·F/n, (k+1)·F/n); each period's leaves come
    gathered at exactly those shapes (the RG-LRU's whole), the period's
    gathered bytes their sum (the float32 smoke tinyllama's 88,576 at
    n = 2 and 50,688 at n = 4, of 176,640 whole); every attention call
    sees H/n query heads and its kv heads, every MLP F/n columns."""
    res = request.getfixturevalue(world)[case]
    cfg = model_config(DECODER_CASES[(world, case)])
    h, kv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    n = res["shape"]["model"]
    per, g = h // n, h // kv
    names = list(res["shape"])
    whole = _period_leaves(res["want"])
    for rank in res["split"]:
        k = rank["coord"][names.index("model")]
        heads = (k * per, (k + 1) * per, ("model",))
        kv_cut = None if kv % n == 0 else (k * per // g,
                                           ((k + 1) * per - 1) // g + 1)
        cols = (k * f // n, (k + 1) * f // n, ("model",))
        assert rank["periods"], rank
        for splits, shapes, nbytes in rank["periods"]:
            blocks = whole[len(shapes)]
            total = 0
            for split, got, want in zip(splits, shapes, blocks):
                has_attn = "['attn']['q']['kernel']" in want
                has_mlp = "['mlp']['wo']['kernel']" in want
                assert split == ((heads if has_attn else None,
                                  kv_cut if has_attn else None,
                                  cols if has_mlp else None)), (rank, split)
                assert set(got) == set(want)
                for path, (shape, size) in want.items():
                    assert got[path] == _local_shape(path, shape, split, n), \
                        (path, got[path], shape)
                    total += int(np.prod(got[path])) * size
            assert nbytes == total, (nbytes, total)
            if h == 8 and all(size == 4 for b in blocks
                              for _, size in b.values()):
                assert nbytes == PERIOD_BYTES[n]
        kv_local = kv // n if kv_cut is None else kv_cut[1] - kv_cut[0]
        assert rank["attend"] == [(per, kv_local)], rank["attend"]
        assert rank["mlp"] == [f // n], rank["mlp"]


def test_world2_checkpoint_restores_at_world_1(world2, directory):
    """Saved whole by the sharded state's ranks, read back unsharded into
    a single-device template, bit for bit; twice (a blocking and a
    non-blocking save)."""
    assert world2["ckpt_steps"] == [3, 4]
    tiny = model_config("tinyllama-1.1b")
    template = Trainer(LanguageModel(tiny), train_config()).init_state(
        torch.Generator().manual_seed(1), "cpu")
    mgr = CheckpointManager(os.path.join(directory, "ckpt_world2"))
    for step in (3, 4):
        restored, got_step = mgr.restore(template, step)
        assert got_step == step and restored.step == 3
        for (path, got), (_, want) in zip(
                tree_flatten(restored), tree_flatten(world2["saved_state"])):
            if isinstance(want, torch.Tensor):
                assert type(got) is torch.Tensor
                assert torch.equal(got, want), path
            else:
                assert got == want, path


def test_world2_checkpoint_restores_in_jax(world2, directory):
    import jax
    mgr = JaxCheckpointManager(os.path.join(directory, "ckpt_world2"))
    saved = tree_flatten(world2["saved_state"])
    template = [np.zeros(tuple(x.shape), np.float32)
                if isinstance(x, torch.Tensor) else np.int32(0)
                for _, x in saved]
    restored, step = mgr.restore(template, 3)
    assert step == 3
    for (path, want), got in zip(saved, jax.tree.leaves(restored)):
        want = want.numpy() if isinstance(want, torch.Tensor) else want
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=path)


def test_world4_restores_the_world2_checkpoint(world4, world2):
    """Into a (4, 1) template (placed like it) and by ``shardings=`` onto
    (2, 2); then moved between the meshes with ``reshard_state``."""
    assert world4["restored_step"] == 3 and world4["restored_is_sharded"]
    want = _leaves(world2["saved_state"])
    for key in ("restored", "restored_by_shardings", "resharded"):
        got = _leaves(world4[key])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g == w) if not isinstance(w, torch.Tensor) else \
                torch.equal(g, w), key
    # on (2, 2) each mesh dim of size 2 halves the dim it splits; the
    # FSDP'd weights are split on both mesh dims
    for shape, dims, local in world4["layout_2x2"]:
        want = list(shape)
        for d in dims:
            if d is not None:
                want[d] //= 2
        assert tuple(want) == local, (shape, dims, local)
    assert any(None not in dims for _, dims, _ in world4["layout_2x2"])


def test_pod_data_rows_match_jax(world4):
    """A dim split over ('pod', 'data'): the rows each rank holds, against
    JAX's ``devices_indices_map`` on a (2, 2) mesh of 4 CPU devices
    (pod major)."""
    code = (
        "import json, jax, numpy as np\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "devs = np.array(jax.devices()[:4]).reshape(2, 2)\n"
        "m = NamedSharding(Mesh(devs, ('pod', 'data')),\n"
        "                  P(('pod', 'data'))).devices_indices_map((8, 3))\n"
        "print(json.dumps({f'{i},{j}': list(range(8))[m[devs[i, j]][0]]\n"
        "                  for i in range(2) for j in range(2)}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = {f"{c[0]},{c[1]}": rows for c, rows in world4["pod_data_rows"]}
    assert got == want
    assert want["0,1"] == [2, 3] and want["1,0"] == [4, 5]


def test_unstack_of_a_placed_stack_moves_nothing(world2):
    """A stack's periods are sliced along the replicated layer dim: no
    collective, each slice on its leaf's placements."""
    assert world2["unstack"] == {"collectives": 0, "placements": True,
                                 "layers": 4}


def test_materialize_a_dim_over_two_mesh_axes(world4):
    """A (8, 3) leaf split on dim 0 over ('pod', 'data') comes back whole
    (major first), and its gradient, summed over both axes, lands on its
    shards."""
    assert world4["two_axes"] == {"whole": True, "placements": True,
                                  "grad": True}


def test_world2_restart_under_the_mesh(world2):
    """``run_with_restarts`` on the mesh: a failure after the step-2 save,
    the state restored sharded and trained on to step 4, equal bit for
    bit to an uninterrupted run."""
    res = world2["restart"]
    assert any("[ft] restored checkpoint at step 2" in line
               for line in res["logs"])
    for (path, got), (_, want) in zip(tree_flatten(res["restarted"]),
                                      tree_flatten(res["straight"])):
        assert (torch.equal(got, want) if isinstance(want, torch.Tensor)
                else got == want), path


def _losses(out):
    return re.findall(r"step (\d+): loss=([0-9.]+)", out)


def test_world2_launch_train_local(world2, tmp_path, capsys):
    """``launch.train.main(["--local", "--device", "cpu", ...])`` in the
    ranks: the mesh run's logged loss equals the single-device run's."""
    rc, out = world2["launch"]
    assert rc == 0
    assert "finished at step 3 on cpu x 2, mesh (2, 1) ('data', 'model')" \
        in out
    assert launch_train.main(["--device", "cpu", "--steps", "3",
                              "--seq-len", "16", "--global-batch", "4",
                              "--ckpt-dir", str(tmp_path)]) == 0
    single = capsys.readouterr().out
    assert _losses(out) == _losses(single) and _losses(out)


def test_world2_serve_local(world2, capsys):
    """``launch.serve.main(["--local", ...])``: params placed with
    ``fsdp=False`` and gathered; the same tokens as one device."""
    rc, out = world2["serve"]
    assert rc == 0 and "3 requests on cpu" in out
    assert launch_serve.main(["--device", "cpu", "--requests", "3"]) == 0
    single = capsys.readouterr().out
    requests = lambda s: [ln for ln in s.splitlines()   # noqa: E731
                          if ln.startswith("request ")]
    assert requests(out) == requests(single) and requests(out)


def test_world2_rules_read_a_device_mesh(world2):
    """``resolve_spec`` on the (2, 1) ``DeviceMesh`` itself."""
    assert world2["mesh_view"] == ("data", "model")

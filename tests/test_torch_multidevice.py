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
``mach_pod_parallel``, (1, 2) in bf16; recurrentgemma-2b (its RG-LRU by
channels too) and seamless-m4t-large-v2 (its cross-attention and K/V
by heads too) on (1, 2) and (1, 4); paligemma-3b, granite-20b,
phi3-mini and mistral-large-123b on (1, 4); each rank's heads, columns,
channels and gathered bytes counted (``SplitCount``), and the cases
beyond tinyllama's their first-step gradients.  The
MoE experts split on ``model`` too: the smoke qwen2-moe-a2.7b by 3 of
its 6 experts a rank on (1, 2) and (2, 2), by 12 of every expert's 48
columns on (1, 4), the smoke mixtral-8x22b by one of its 4 experts a
rank on (1, 4); each rank's experts or columns, shared-MLP columns,
gathered bytes, routing and first-step gradients counted.

Each world is spawned once (module fixtures: ``world2``, ``world4`` and
``world4_split``, a second world of 4 for the decoder split of the
configs past tinyllama, so that each stays inside its deadline) and
runs every check inside; the tests read what its rank 0 wrote.  The worlds join by a
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
recurrentgemma-2b's split cases at 0.05% (``RG_OFF_SHARE``; its floor
is 0.0292% once the RG-LRU's output moves by its ulp too, and its
splits sit at 0.0192% and 0.0204%).  The further decoder split cases,
whose one-ulp perturbation also moves every cross-attention's output,
at twice their floors rounded up to two digits: seamless-m4t-large-v2
0.13% (floor 0.0648%, its zero-initialised LayerNorm biases and the
audio adapter hold most of the noise-set entries), paligemma-3b
0.031% (0.0151%), granite-20b 0.021% (0.0104%), phi3-mini 0.026%
(0.0127%), mistral-large-123b 0.027% (0.0133%); their first-step
gradients within 1e-5 of each leaf's largest (``SPLIT_GRAD_RTOL``).
The MoE
split cases sum each rank's float32 partial expert outputs too; they
are held at twice their config's floor (0.0119% qwen2-moe-a2.7b, 48 of
403,776 entries; 0.0079% mixtral-8x22b, 30 of 378,432), rounded up to
two digits: 0.024% (``QWEN_MOE_OFF_SHARE``) and 0.016%
(``MIXTRAL_OFF_SHARE``); their first-step gradients within 1e-5 of
each leaf's largest entry (``SPLIT_GRAD_RTOL``; at most 2.9e-6
measured, the mixtral router's on (1, 4)).
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
from torch_multidevice_ranks import (DECODER_WORLD4, mach_model_config,
                                     model_config, rglru_channels,
                                     spawn_world, train_config)

RTOL = 1e-6
BF16_RTOL = 2.0 ** -6
OFF_SHARE = 1e-4
XLSTM_OFF_SHARE = 1e-3
MACH_OFF_SHARE = 2.5e-4
RG_OFF_SHARE = 5e-4
QWEN_MOE_OFF_SHARE = 2.4e-4
MIXTRAL_OFF_SHARE = 1.6e-4
SEAMLESS_OFF_SHARE = 1.3e-3
PALIGEMMA_OFF_SHARE = 3.1e-4
GRANITE_OFF_SHARE = 2.1e-4
PHI3_OFF_SHARE = 2.6e-4
MISTRAL_OFF_SHARE = 2.7e-4
SPLIT_GRAD_RTOL = 1e-5
# the decoder split cases of these configs, at twice each one's one-ulp
# floor (tools/split_noise_floor.py), recurrentgemma-2b's below it
DECODER_OFF_SHARE = {"recurrentgemma-2b": RG_OFF_SHARE,
                     "seamless-m4t-large-v2": SEAMLESS_OFF_SHARE,
                     "paligemma-3b": PALIGEMMA_OFF_SHARE,
                     "granite-20b": GRANITE_OFF_SHARE,
                     "phi3-mini-3.8b": PHI3_OFF_SHARE,
                     "mistral-large-123b": MISTRAL_OFF_SHARE}
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


@pytest.fixture(scope="module")
def world4_split(directory):
    return spawn_world(4, "world4_split", directory, WORLD_TIMEOUT)


def _leaves(tree):
    return [x for _, x in tree_flatten(tree)]


def _hold_grads(res) -> list:
    """``res``'s first-step gradients, sharded (made whole) and on one
    device, held leaf by leaf within ``SPLIT_GRAD_RTOL`` of the leaf's
    largest entry.  Returns the leaves' paths."""
    got, want = tree_flatten(res["grads"]), tree_flatten(res["want_grads"])
    assert [p for p, _ in got] == [p for p, _ in want]
    worst = 0.0
    for (path, g), (_, w) in zip(got, want):
        assert type(g) is torch.Tensor and g.shape == w.shape, path
        err = float((g - w).abs().max())
        assert err <= SPLIT_GRAD_RTOL * float(w.abs().max()), (path, err)
        worst = max(worst, err / max(float(w.abs().max()), 1e-30))
    print(f"first-step gradients: at most {worst:.3e} of a leaf's largest "
          f"entry")
    return [p for p, _ in want]


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
                 ("world2", "tp12_seamless"): "seamless-m4t-large-v2",
                 ("world4", "mesh2x2"): "tinyllama-1.1b",
                 ("world4", "tp14"): "tinyllama-1.1b"} | {
                     ("world4_split", case): arch
                     for case, arch in DECODER_WORLD4.items()} | {
                     case: "tinyllama-1.1b" for case in HEAD_CASES}
# the float32 smoke tinyllama's gathered bytes of one period a rank, by
# the ranks on ``model`` (k and v split at 2, cut from the whole at 4)
PERIOD_BYTES = {1: 176_640, 2: 88_576, 4: 50_688}
# the float32 decoder split cases held by their first step's gradients
# (``split_case(..., grads=True)``)
GRAD_CASES = [("world2", "tp12_rg"), ("world2", "tp12_seamless")] + [
    ("world4_split", case) for case in DECODER_WORLD4]


@pytest.mark.parametrize("world,case", [
    ("world2", "tp12"), ("world2", "tp12_rg"), ("world2", "tp12_seamless"),
    ("world4", "tp14")] + [("world4_split", case) for case in DECODER_WORLD4])
def test_decoder_split_matches_one_device(request, world, case):
    """The smoke tinyllama with its decoder split on (1, 2) (each rank
    its 4 query heads, its kv head and 88 MLP columns) and on (1, 4) (2
    query heads, the kv head they read cut from the whole k and v, 44
    columns), recurrentgemma-2b on (1, 2) and (1, 4) (its RG-LRU on 32
    and 16 channels), seamless-m4t-large-v2 on (1, 2) and (1, 4) (every
    attention, the cross-attention and its K/V with it, by heads), and
    paligemma-3b, granite-20b, phi3-mini and mistral-large-123b on (1,
    4), against one device ((2, 2) is ``mesh2x2`` above, and the MACH
    head's cases split the decoder too): every metric at rtol 1e-6, the
    params by the share past 1e-6 of their leaf's largest, each config
    at its own bound (``DECODER_OFF_SHARE``)."""
    bound = DECODER_OFF_SHARE.get(DECODER_CASES[(world, case)], OFF_SHARE)
    assert _hold(request.getfixturevalue(world)[case]) <= bound


@pytest.mark.parametrize("world,case", GRAD_CASES)
def test_decoder_split_gradients_match_one_device(request, world, case):
    """The first step's gradients (before clipping) of the decoder split
    cases above, made whole, against one device's, leaf by leaf within
    ``SPLIT_GRAD_RTOL`` of the leaf's largest entry: the RG-LRU's gates
    (each rank's rows, from the all-gathered gradient of their
    pre-activations), the cross K/V (summed over the encoder output's
    ranks once) and the encoder's leaves among them."""
    _hold_grads(request.getfixturevalue(world)[case])


def test_decoder_split_bf16_within_its_tolerance(world2):
    """The bf16 smoke tinyllama with its decoder split on (1, 2): every
    metric, the first loss too, at rtol 2^-6, the params within 2·Σlr
    (the partial outputs are rounded to bf16, then summed in bf16)."""
    _hold(world2["tp12_bf16"], bf16=True, split=True)


def _whole_period(params, shapes) -> list:
    """The decoder's or the encoder's period whose blocks have the leaf
    paths of ``shapes`` (a ``SplitCount`` period's): each block's
    leaves' (shape less the layer dim, bytes an entry), by path."""
    periods = [[{path: (tuple(x.shape[1:]), x.element_size())
                 for path, x in tree_flatten(block)} for block in p_list]
               for key in ("stacks", "enc_stacks")
               for p_list in params.get(key, [])]
    return next(blocks for blocks in periods if len(blocks) == len(shapes)
                and all(set(b) == set(s) for b, s in zip(blocks, shapes)))


def _heads_local(path, shape, kv, n):
    """An attention leaf (q, k, v or o) on a rank of n query-head
    ranges: q and o cut to H/n heads, k and v to KV/n unless the rank
    cuts its kv heads ``kv`` from the whole."""
    if "['q']" in path or ("['o']" not in path and kv is None):
        shape[1] //= n
    elif "['o']" in path:
        shape[0] //= n


def _local_shape(path, shape, split, n, rglru=None, xattn=None):
    """A leaf's shape on a rank of n whose block splits as ``split``
    (``SplitCount``'s (attention heads, kv cut, MLP columns)), its
    RG-LRU's channels ``rglru`` and its cross-attention's (heads, kv
    cut) ``xattn``."""
    attn, kv, mlp = split or (None, None, None)
    shape = list(shape)
    if attn and path.startswith("['attn']"):
        _heads_local(path, shape, kv, n)
    if xattn and path.startswith("['xattn']"):
        _heads_local(path, shape, xattn[1], n)
    if mlp and path.startswith("['mlp']"):
        shape[0 if "['wo']" in path else -1] //= n
    if rglru and path.startswith("['rglru']"):
        last = any(f"['{key}']" in path for key in ("lin_y", "lin_x", "w"))
        shape[-1 if last else 0] //= n
    return tuple(shape)


def _heads_split(h, kv, n) -> bool:
    """Whether the rules split an attention of H query and KV kv heads
    over n ``model`` ranks (``split_plan``)."""
    per, g = h // n, h // kv
    return h % n == 0 and (kv % n == 0 or per % g == 0 or g % per == 0)


@pytest.mark.parametrize("world,case", list(DECODER_CASES))
def test_decoder_split_computes_its_heads_and_columns(request, world, case):
    """Counted around the sharded steps (``SplitCount``): rank k of the n
    ``model`` ranks splits every block with self-attention on query
    heads [k·H/n, (k+1)·H/n) where the rules split them, its k and v
    split with them where n divides KV and else cut to the kv heads they
    read, every ``xattn`` block's cross-attention the same, every block
    with an MLP on columns [k·F/n, (k+1)·F/n) and every RG-LRU block on
    channels [k·W/n, (k+1)·W/n); each period's leaves (the encoder's
    too) come gathered at exactly those shapes, the period's gathered
    bytes their sum (the float32 smoke tinyllama's 88,576 at n = 2 and
    50,688 at n = 4, of 176,640 whole); every attention call sees its
    query and kv heads, every MLP its columns, every ``ops.lru_scan``
    call W/n channels and every cross K/V its kv heads."""
    res = request.getfixturevalue(world)[case]
    cfg = model_config(DECODER_CASES[(world, case)])
    h, kv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    w = cfg.resolved_rnn_width
    n = res["shape"]["model"]
    per, g = h // n, h // kv
    split_heads = _heads_split(h, kv, n)
    names = list(res["shape"])
    for rank in res["split"]:
        k = rank["coord"][names.index("model")]
        heads = (k * per, (k + 1) * per, ("model",)) if split_heads else None
        kv_cut = None if not split_heads or kv % n == 0 else (
            k * per // g, ((k + 1) * per - 1) // g + 1)
        cols = (k * f // n, (k + 1) * f // n, ("model",)) \
            if f % n == 0 else None
        chans = (k * w // n, (k + 1) * w // n, ("model",)) \
            if w % n == 0 else None
        assert rank["periods"], rank
        assert len(rank["rglru"]) == len(rank["xattn"]) == \
            len(rank["periods"])
        for (splits, shapes, nbytes), rglru, xattn in zip(
                rank["periods"], rank["rglru"], rank["xattn"]):
            blocks = _whole_period(res["want"], shapes)
            total = 0
            for split, r_split, x_split, got, want in zip(
                    splits, rglru, xattn, shapes, blocks):
                has_attn = "['attn']['q']['kernel']" in want
                has_mlp = "['mlp']['wo']['kernel']" in want
                has_rglru = "['rglru']['lin_out']['kernel']" in want
                has_xattn = "['xattn']['q']['kernel']" in want
                assert split == ((heads if has_attn else None,
                                  kv_cut if has_attn else None,
                                  cols if has_mlp else None)), (rank, split)
                assert r_split == (chans if has_rglru else None), r_split
                assert x_split == ((heads, kv_cut) if has_xattn and heads
                                   else None), x_split
                assert set(got) == set(want)
                for path, (shape, size) in want.items():
                    local = _local_shape(path, shape, split, n, r_split,
                                         x_split)
                    assert got[path] == local, (path, got[path], shape)
                    total += int(np.prod(got[path])) * size
            assert nbytes == total, (nbytes, total)
            if h == 8 and all(size == 4 for b in blocks
                              for _, size in b.values()):
                assert nbytes == PERIOD_BYTES[n]
        kv_local = kv if not split_heads else (
            kv // n if kv_cut is None else kv_cut[1] - kv_cut[0])
        assert rank["attend"] == [(per if split_heads else h, kv_local)], \
            rank["attend"]
        assert rank["mlp"] == [f // n if cols else f], rank["mlp"]
        assert rank["scan"] == ([w // n if chans else w]
                                if "rglru" in cfg.block_pattern else []), \
            rank["scan"]
        assert rank["cross_kv"] == ([kv_local] if cfg.num_encoder_layers
                                    else []), rank["cross_kv"]


class _HandSplit:
    """A rank's ``RangeSplit`` of channels [r0, r1) without a world:
    ``into`` and ``out_of`` the identity (the rank's partial output
    comes out), ``onto_range`` each gate's pre-activations summed over
    the ranks by hand (``sums``, in call order), checking the rank's
    partial against ``partials``."""

    def __init__(self, r0, r1, partials, sums):
        self.r0, self.r1 = r0, r1
        self.partials, self.sums = list(partials), list(sums)

    def into(self, x):
        return x

    def out_of(self, x):
        return x

    def onto_range(self, x):
        assert torch.equal(x, self.partials.pop(0))
        return self.sums.pop(0)[..., self.r0:self.r1]


@pytest.mark.parametrize("n", [2, 4])
def test_rglru_on_a_channel_range(n):
    """``recurrent.apply_rglru_block(split=)`` on each of n ranks'
    channels [k·W/n, (k+1)·W/n) (the rank's columns of lin_y and lin_x,
    conv and Λ entries, rows of gate_a, gate_x and lin_out): each rank's
    gate partials are its rows' xc_k @ W[rows_k]; summed over the ranks
    by hand and cut to each rank's channels they feed its recurrence, and
    the ranks' partial outputs sum to the whole block's at float32 rtol
    1e-6 (atol 1e-6 of its largest entry)."""
    from repro_torch.models import layers, recurrent
    gen = torch.Generator().manual_seed(n)
    d, w = 32, 64
    params = recurrent.init_rglru_block(gen, d, w, "cpu")
    x = torch.randn((2, 12, d), generator=gen)
    whole, _ = recurrent.apply_rglru_block(params, x)
    per = w // n
    locals_, partials = [], []
    for k in range(n):
        local = rglru_channels(params, k * per, (k + 1) * per)
        xc, _ = recurrent._causal_conv(local["conv"],
                                       layers.dense(local["lin_x"], x), None)
        partials.append([layers.dense(local[key], xc)
                         for key in ("gate_a", "gate_x")])
        locals_.append(local)
    sums = [sum(p[i] for p in partials) for i in range(2)]
    total = torch.zeros_like(whole)
    for k, local in enumerate(locals_):
        split = _HandSplit(k * per, (k + 1) * per, partials[k], sums)
        y, state = recurrent.apply_rglru_block(local, x, split=split)
        assert state.h.shape == (2, per)
        total = total + y
    torch.testing.assert_close(total, whole, rtol=1e-6,
                               atol=1e-6 * float(whole.abs().max()))


# the MoE experts split on ``model``: (world, case) -> (arch, how the
# experts split, the share bound, the float32 bytes a rank gathers of
# one period, of the whole period's)
MOE_CASES = {
    ("world2", "moe12"): ("qwen2-moe-a2.7b", "experts", QWEN_MOE_OFF_SHARE,
                          182_528, 362_752),
    ("world4", "moe14"): ("qwen2-moe-a2.7b", "columns", QWEN_MOE_OFF_SHARE,
                          92_416, 362_752),
    ("world4", "moe14_mixtral"): ("mixtral-8x22b", "experts",
                                  MIXTRAL_OFF_SHARE, 99_840, 345_600),
    ("world4", "moe22"): ("qwen2-moe-a2.7b", "experts", QWEN_MOE_OFF_SHARE,
                          182_528, 362_752)}


@pytest.mark.parametrize("world,case", list(MOE_CASES))
def test_moe_split_matches_one_device(request, world, case):
    """The smoke qwen2-moe-a2.7b with its experts split by expert on
    (1, 2) and (2, 2) and by columns on (1, 4), and the smoke
    mixtral-8x22b by expert on (1, 4) (the attention and the shared MLP
    split too), against one device: every metric (the aux losses too)
    at rtol 1e-6, the params after two AdamW steps by the share past
    1e-6 of their leaf's largest, at twice the config's one-ulp floor."""
    bound = MOE_CASES[(world, case)][2]
    assert _hold(request.getfixturevalue(world)[case]) <= bound


@pytest.mark.parametrize("world,case", list(MOE_CASES))
def test_moe_split_gradients_match_one_device(request, world, case):
    """The first step's gradients (before clipping), made whole, against
    one device's, leaf by leaf within ``SPLIT_GRAD_RTOL`` of the leaf's
    largest entry: the router's and ``shared_gate``'s among them, which
    are one device's on every rank (the gates' gradient is summed over
    the split before it reaches the router), so they are not summed over
    ``model`` again."""
    res = request.getfixturevalue(world)[case]
    paths = " ".join(_hold_grads(res))
    assert "['router']" in paths
    assert ("['shared_gate']" in paths) == MOE_CASES[(world, case)][
        0].startswith("qwen2")


@pytest.mark.parametrize("world,case", list(MOE_CASES))
def test_moe_split_routes_the_same_on_every_model_rank(request, world,
                                                        case):
    """Every rank routes the whole input: each ``moe.route`` call's
    expert ids and kept mask (every layer, forward and remat's
    recompute, both steps) are the same on every ``model`` rank of a
    ``data`` row shard, exactly."""
    res = request.getfixturevalue(world)[case]
    names = list(res["shape"])
    by_rows = {}
    for rank in res["split"]:
        rows = rank["coord"][names.index("data")]
        by_rows.setdefault(rows, []).append(rank["routing"])
    assert len(by_rows) == res["shape"]["data"]
    for shards in by_rows.values():
        first = shards[0]
        assert first and len(shards) == res["shape"]["model"]
        for other in shards[1:]:
            assert len(other) == len(first)
            for (e0, k0), (e1, k1) in zip(first, other):
                assert torch.equal(e0, e1) and torch.equal(k0, k1)


def _moe_local_shape(path, shape, moe, n):
    """A MoE leaf's shape on a rank of n whose experts split as ``moe``
    (``SplitCount``'s (mode, routed range, shared range))."""
    mode, _, shared = moe
    shape = list(shape)
    if path.startswith("['moe']['shared']"):
        if shared:
            shape[0 if "['wo']" in path else -1] //= n
    elif any(f"['moe']['{key}']" in path for key in ("wi", "wg", "wo")):
        if mode == "experts":
            shape[0] //= n
        elif mode == "columns":
            shape[1 if "['wo']" in path else -1] //= n
    return tuple(shape)


@pytest.mark.parametrize("world,case", list(MOE_CASES))
def test_moe_split_computes_its_experts_or_columns(request, world, case):
    """Counted around the sharded steps (``SplitCount``): rank k of the n
    ``model`` ranks takes experts [k·E/n, (k+1)·E/n) where n divides E
    (qwen2-moe's 6 on 2, mixtral's 4 on 4), else every expert's columns
    [k·F/n, (k+1)·F/n) (qwen2-moe's 48 on 4), the shared MLP's columns
    [k·Fs/n, (k+1)·Fs/n) and its attention heads; each period's leaves
    come gathered at those shapes, the router and ``shared_gate`` whole;
    the period's gathered bytes are their sum, the arithmetic's (e.g.
    182,528 of qwen2-moe's 362,752 a period at n = 2); every expert call
    sees its E/n experts' or F/n columns' kernels and G·cap rows an
    expert, every attention call H/n heads and every shared MLP call
    Fs/n columns."""
    from repro_torch.models.moe import capacity
    res = request.getfixturevalue(world)[case]
    arch, mode, _, period_bytes, whole_bytes = MOE_CASES[(world, case)]
    cfg = model_config(arch)
    e, f, fs = cfg.num_experts, cfg.moe_d_ff, cfg.shared_d_ff
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    n, rows = res["shape"]["model"], res["shape"]["data"]
    names = list(res["shape"])
    per, g = h // n, h // kv
    whole, = _whole_period(res["want"], res["split"][0]["periods"][0][1])
    assert sum(int(np.prod(shape)) * size
               for shape, size in whole.values()) == whole_bytes
    group = cfg.moe_group_size
    groups = 4 // rows * 16 // group          # the rank's rows of 4 x 16
    cap = capacity(group, cfg.experts_top_k, cfg.capacity_factor, e)
    for rank in res["split"]:
        k = rank["coord"][names.index("model")]
        size = e if mode == "experts" else f
        routed = (k * size // n, (k + 1) * size // n, ("model",))
        shared = (k * fs // n, (k + 1) * fs // n, ("model",)) if fs else None
        heads = (k * per, (k + 1) * per, ("model",))
        kv_cut = None if kv % n == 0 else (k * per // g,
                                           ((k + 1) * per - 1) // g + 1)
        assert rank["periods"] and len(rank["moe"]) == len(rank["periods"])
        for moe_split, (splits, shapes, nbytes) in zip(rank["moe"],
                                                        rank["periods"]):
            assert moe_split == ((mode, routed, shared),), moe_split
            assert splits == ((heads, kv_cut, None),), splits
            total = 0
            for (path, (shape, size)) in whole.items():
                want = _moe_local_shape(path, _local_shape(
                    path, shape, splits[0], n), moe_split[0], n)
                assert shapes[0][path] == want, (path, shapes[0][path], want)
                total += int(np.prod(want)) * size
            assert set(shapes[0]) == set(whole)
            assert nbytes == total == period_bytes, (nbytes, total)
        local_e = e // n if mode == "experts" else e
        local_f = f if mode == "experts" else f // n
        assert rank["experts"] == [((local_e, d, local_f),
                                    (local_e, groups * cap, d))], \
            rank["experts"]
        kv_local = kv // n if kv_cut is None else kv_cut[1] - kv_cut[0]
        assert rank["attend"] == [(per, kv_local)], rank["attend"]
        assert rank["mlp"] == ([fs // n] if fs else []), rank["mlp"]


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


def test_dry_run_step_matches_a_real_world(world4_split):
    """Rank 0 of a fake world of 4 on fake tensors (``dryrun.dry_step``,
    mesh (1, 4)) against rank 0 of ``world4_split``'s real gloo world on
    the same mesh (``counted_step``): one step of the smoke tinyllama
    with its MACH head split by repetition and its decoder by heads and
    hidden, the same flops, bytes, kernels and collectives by kind
    exactly, and the dry run's argument bytes the real rank's placed
    local state and batch."""
    from repro_torch.launch import dryrun
    from repro_torch.sharding import ShardingRules
    real = world4_split["counted_step"]
    spec = dict(kind="train", seq_len=16, global_batch=4, world=4,
                model_axis=4, train_config=train_config())
    fake = dryrun.dry_step(mach_model_config(), spec, ShardingRules())
    got, want = fake["counts"].summary(), real["counts"]
    assert got["collectives"] and got["kernels"]["mach_xent_fwd"]
    assert got == want
    assert fake["memory"]["per_device_argument_bytes"] == \
        real["state_bytes"] + real["batch_bytes"]


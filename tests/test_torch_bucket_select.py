"""Dynamic bucket selection in the port against the JAX package, on the
CPU: the proxy, the selection, the selected fused loss (dense and CSR),
the heads' ``bucket_proxy_scores`` and ``fused_loss(bucket_select=...)``,
and the ``Trainer``'s proxy cache.

The oracles come from ``repro.kernels.ref``; JAX's heads and trainer
reach ``repro.kernels.ops`` (which sends CPU arrays to ``ref.py``), so
they run inside ``tests/torch_reference.py``'s ``jax_reference()``.
Same numpy inputs to both sides.

Tolerances: the proxy at rtol 1e-6 (atol 1e-6 of the largest entry,
float32 sums in another order); the selected ids exactly, ties and
all-equal proxies included (``jax.lax.top_k`` breaks ties to the lower
index; the port sorts stably); losses at rtol 1e-5 and gradients at
rtol 1e-5 / atol 1e-6, the fused-xent tests' tolerances; unselected
columns' gradients exactly zero; ``c_sel >= B`` bit for bit the
unselected path; five trainer steps at test_torch_train.py's tolerances
(losses rtol 1e-5, params rtol 1e-4 / atol 1e-6) on its nonnegative
unit-norm features.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mach as jm
from repro.kernels import ref as jref
from repro.train import trainer as jtrainer
from repro.train.train_state import new_train_state as jax_new_train_state
from repro_torch import convert
from repro_torch.core import mach as tm
from repro_torch.data.extreme import SparseBatch
from repro_torch.kernels import mach_fused_xent as mfx
from repro_torch.kernels import ops, ref
from repro_torch.train import TrainConfig, Trainer, new_train_state
from torch_reference import jax_reference

RTOL, ATOL = 1e-5, 1e-6


def _head(rng, d, r, b):
    w = (rng.normal(size=(d, r * b)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(r * b,))).astype(np.float32)
    return w, bias


def _csr(rng, n, d, nnz_max):
    lengths = rng.integers(1, nnz_max + 1, size=n)
    lengths[0], lengths[1] = nnz_max, 0
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    indices = rng.integers(0, d, size=int(indptr[-1])).astype(np.int32)
    indices[1:3] = indices[0]                       # duplicates in row 0
    values = rng.uniform(0.05, 1.0, size=indices.shape).astype(np.float32)
    return indptr, indices, values


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the proxy and the selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
def test_proxy_matches_jax(bias):
    rng = np.random.default_rng(1)
    n, d, r, b = 11, 40, 3, 16
    h = rng.normal(size=(n, d)).astype(np.float32)
    w, bb = _head(rng, d, r, b)
    bb = bb if bias else None
    want = jref.mach_bucket_proxy_ref(*_j(h, w), b, bias=_j(bb)[0])
    tw = torch.from_numpy(w).requires_grad_(True)
    got = ops.mach_bucket_proxy(torch.from_numpy(h), tw, num_buckets=b,
                                bias=_t(bb)[0])
    assert got.shape == (r, b) and got.dtype == torch.float32
    assert not got.requires_grad                    # stop_gradient
    scale = float(np.abs(np.asarray(want)).max())
    _close(got, want, rtol=1e-6, atol=1e-6 * scale)
    # leading dims are flattened, as the JAX op does
    got3 = ops.mach_bucket_proxy(torch.from_numpy(h[:10]).reshape(2, 5, d),
                                 tw, num_buckets=b, bias=_t(bb)[0])
    want3 = jref.mach_bucket_proxy_ref(*_j(h[:10], w), b, bias=_j(bb)[0])
    _close(got3, want3, rtol=1e-6, atol=1e-6 * scale)
    # the CSR batch: the mean is a scatter-add (duplicates, an empty row)
    indptr, indices, values = _csr(rng, n, d, 6)
    want = jref.mach_bucket_proxy_csr_ref(*_j(indptr, indices, values, w), b,
                                          bias=_j(bb)[0])
    got = ops.mach_bucket_proxy(w=tw, num_buckets=b, bias=_t(bb)[0],
                                csr=_t(indptr, indices, values))
    assert not got.requires_grad
    _close(got, want, rtol=1e-6,
           atol=1e-6 * float(np.abs(np.asarray(want)).max()))


def _proxies(rng, r, b):
    """Random, dyadic with ties in bulk, all equal, signed zeros."""
    dyadic = rng.integers(-4, 5, size=(r, b)).astype(np.float32) / 8
    zeros = np.where(rng.uniform(size=(r, b)) < 0.5, -0.0, 0.0)
    return {"random": rng.normal(size=(r, b)).astype(np.float32),
            "ties": dyadic, "all equal": np.full((r, b), 0.5, np.float32),
            "signed zeros": zeros.astype(np.float32)}


@pytest.mark.parametrize("c_sel", [1, 3, 8, 15, 16])
def test_select_buckets_equal_jax_exactly(c_sel):
    rng = np.random.default_rng(c_sel)
    r, b = 4, 16
    for name, proxy in _proxies(rng, r, b).items():
        for n in (1, 2, 6, 40):          # labels: under and over c_sel
            y = rng.integers(0, b, size=(n, r)).astype(np.int32)
            want = np.asarray(jref.mach_select_buckets_ref(*_j(proxy, y), b,
                                                           c_sel))
            got = ops.mach_select_buckets(*_t(proxy, y), num_buckets=b,
                                          c_sel=c_sel)
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            # label buckets are force-included while they fit
            for j in range(r):
                present = set(y[:, j].tolist())
                if len(present) <= c_sel:
                    assert present <= set(got[j].tolist()), name
    with pytest.raises(ValueError, match="c_sel"):
        ops.mach_select_buckets(torch.zeros(r, b), torch.zeros((2, r),
                                dtype=torch.int32), num_buckets=b, c_sel=0)


def test_select_buckets_ties_go_to_the_lower_id():
    """All-equal proxies and no labels' pull: the lowest ids win; among
    the forced label buckets, too."""
    proxy = torch.zeros(2, 8)
    y = torch.tensor([[6, 7], [5, 7]], dtype=torch.int32)
    got = ops.mach_select_buckets(proxy, y, num_buckets=8, c_sel=3)
    assert got.tolist() == [[0, 5, 6], [0, 1, 7]]
    got = ops.mach_select_buckets(proxy, torch.tensor([[6, 7], [5, 2],
                                                       [4, 3]],
                                                      dtype=torch.int32),
                                  num_buckets=8, c_sel=2)
    assert got.tolist() == [[4, 5], [2, 3]]


# ---------------------------------------------------------------------------
# the selected fused loss
# ---------------------------------------------------------------------------

def _dense_case(seed, n=13, d=24, r=3, b=16):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w, bb = _head(rng, d, r, b)
    y = rng.integers(0, b, size=(n, r)).astype(np.int32)
    return rng, h, w, bb, y


def _jax_selected(h, w, bb, y, selected, b, csr=None):
    """JAX's selected loss summed under weights g, and its gradients wrt
    (w, bias)."""
    g = np.linspace(0.5, 1.5, y.shape[0]).astype(np.float32)

    def f(w_, b_):
        if csr is None:
            out = jref.mach_fused_xent_selected_ref(
                jnp.asarray(h), w_, jnp.asarray(y), jnp.asarray(selected),
                b, bias=b_)
        else:
            out = jref.mach_fused_xent_csr_selected_ref(
                *_j(*csr), w_, jnp.asarray(y), jnp.asarray(selected), b,
                bias=b_)
        return jnp.sum(out * g), out

    (_, out), (gw, gb) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        *_j(w, bb))
    return out, gw, gb, g


@pytest.mark.parametrize("c_sel", [1, 5, 11])
def test_selected_dense_loss_and_grads_match_jax(c_sel):
    rng, h, w, bb, y = _dense_case(c_sel)
    b = 16
    proxy = rng.normal(size=(3, b)).astype(np.float32)
    selected = np.asarray(jref.mach_select_buckets_ref(*_j(proxy, y), b,
                                                       c_sel))
    out, gw, gb, g = _jax_selected(h, w, bb, y, selected, b)
    tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (w, bb))
    got = ops.mach_fused_xent_selected(torch.from_numpy(h), tw,
                                       torch.from_numpy(y),
                                       torch.from_numpy(selected.copy()),
                                       num_buckets=b, bias=tb)
    _close(got, out)
    (got * torch.from_numpy(g)).sum().backward()
    _close(tw.grad, gw)
    _close(tb.grad, gb)
    # every unselected column's gradient is exactly zero
    keep = np.zeros((3, b), bool)
    keep[np.arange(3)[:, None], selected] = True
    assert torch.all(tw.grad.reshape(-1, 3, b)[:, ~torch.from_numpy(keep)]
                     == 0)
    assert torch.all(tb.grad.reshape(3, b)[~torch.from_numpy(keep)] == 0)
    # the op's own dispatch, with this proxy passed as the cache
    via = ops.mach_fused_xent(torch.from_numpy(h), torch.from_numpy(w),
                              torch.from_numpy(y), num_buckets=b,
                              bias=torch.from_numpy(bb),
                              bucket_select=(c_sel, 1),
                              bucket_proxy=torch.from_numpy(proxy))
    assert torch.equal(via, got.detach())


@pytest.mark.parametrize("impl,nnz_max", [("densify", 6), ("gather", 600)])
def test_selected_csr_loss_and_grads_match_jax(monkeypatch, impl, nnz_max):
    """The CSR selection runs the ELL family below GATHER_NNZ_THRESHOLD
    and the gather family from it, at B' = c_sel."""
    rng = np.random.default_rng(nnz_max)
    n, d, r, b, c_sel = 9, 700, 2, 12, 7
    csr = _csr(rng, n, d, nnz_max)
    w, bb = _head(rng, d, r, b)
    y = rng.integers(0, b, size=(n, r)).astype(np.int32)
    proxy = np.asarray(jref.mach_bucket_proxy_csr_ref(*_j(*csr, w), b,
                                                      bias=jnp.asarray(bb)))
    selected = np.asarray(jref.mach_select_buckets_ref(*_j(proxy, y), b,
                                                       c_sel))
    out, gw, gb, g = _jax_selected(None, w, bb, y, selected, b, csr=csr)
    tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (w, bb))
    calls = {"ell": [], "gather": []}
    for fam in calls:
        real = getattr(mfx, f"mach_fused_xent_{fam}")

        def spy(*a, _real=real, _fam=fam):
            calls[_fam].append(a[-1])               # num_buckets
            return _real(*a)
        monkeypatch.setattr(mfx, f"mach_fused_xent_{fam}", spy)
    got = ops.mach_fused_xent_csr(*_t(*csr), tw, torch.from_numpy(y),
                                  num_buckets=b, nnz_max=nnz_max, bias=tb,
                                  bucket_select=(c_sel, 1))
    assert calls == {"ell": [c_sel] * (impl == "densify"),
                     "gather": [c_sel] * (impl == "gather")}
    _close(got, out)
    (got * torch.from_numpy(g)).sum().backward()
    _close(tw.grad, gw)
    _close(tb.grad, gb)
    keep = np.zeros((r, b), bool)
    keep[np.arange(r)[:, None], selected] = True
    assert torch.all(tw.grad.reshape(d, r, b)[:, ~torch.from_numpy(keep)]
                     == 0)


@pytest.mark.parametrize("c_sel", [16, 17, 40])
def test_c_sel_at_or_above_b_is_the_unselected_path_bit_for_bit(c_sel):
    _, h, w, bb, y = _dense_case(3)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (w, bb)]
    base = ops.mach_fused_xent(torch.from_numpy(h), *leaves[:1],
                               torch.from_numpy(y), num_buckets=16,
                               bias=leaves[1])
    base_grads = torch.autograd.grad(base.sum(), leaves)
    sel = ops.mach_fused_xent(torch.from_numpy(h), *leaves[:1],
                              torch.from_numpy(y), num_buckets=16,
                              bias=leaves[1], bucket_select=(c_sel, 5),
                              bucket_proxy=torch.zeros(3, 16))
    sel_grads = torch.autograd.grad(sel.sum(), leaves)
    assert torch.equal(base, sel)
    for a, c in zip(base_grads, sel_grads):
        assert torch.equal(a, c)


@pytest.mark.parametrize("c_sel", [2, 6, 12])
def test_selected_bias_is_one_sided_and_bounded(c_sel):
    """Each repetition's labels take at most c_sel buckets, so all are
    force-included: 0 <= full − selected loss <= the bound."""
    rng, h, w, bb, _ = _dense_case(10 + c_sel, n=8)
    buckets = np.stack([rng.permutation(16)[:c_sel] for _ in range(3)])
    y = buckets[np.arange(3), rng.integers(0, c_sel, size=(8, 3))]
    y = y.astype(np.int32)
    full = ops.mach_fused_xent(*_t(h, w, y), num_buckets=16,
                               bias=torch.from_numpy(bb))
    proxy = ops.mach_bucket_proxy(*_t(h, w), num_buckets=16,
                                  bias=torch.from_numpy(bb))
    selected = ops.mach_select_buckets(proxy, torch.from_numpy(y),
                                       num_buckets=16, c_sel=c_sel)
    for j in range(3):
        assert set(y[:, j].tolist()) <= set(selected[j].tolist())
    part = ops.mach_fused_xent_selected(*_t(h, w, y), selected,
                                        num_buckets=16,
                                        bias=torch.from_numpy(bb))
    bound = ref.mach_selected_bias_bound_ref(*_t(h, w, y), selected, 16,
                                             bias=torch.from_numpy(bb))
    want = jref.mach_selected_bias_bound_ref(*_j(h, w, y), jnp.asarray(
        selected.numpy()), 16, bias=jnp.asarray(bb))
    _close(bound, want)
    gap = full - part
    assert torch.all(gap >= -1e-5) and torch.all(gap <= bound + 1e-5)
    assert float(gap.max()) > 0


def test_labels_at_the_selection_edge_and_beyond_it():
    """A label at the selection's edge (its lowest and highest bucket
    ids, the last force-included rank) keeps its exact positive term; a
    batch with more distinct label buckets than c_sel maps the labels
    left out to position 0, as the JAX package does, without raising."""
    rng, h, w, bb, _ = _dense_case(21, n=6)
    b, c_sel = 16, 3
    # repetition 0: labels {0, 15, 7} fill the selection exactly
    y = np.array([[0, 1, 2], [15, 1, 2], [7, 1, 2], [0, 1, 2], [15, 1, 2],
                  [7, 1, 2]], np.int32)
    proxy = rng.normal(size=(3, b)).astype(np.float32)
    selected = ops.mach_select_buckets(*_t(proxy, y), num_buckets=b,
                                       c_sel=c_sel)
    assert selected[0].tolist() == [0, 7, 15]
    pos = ref.label_positions(selected, torch.from_numpy(y))
    assert pos[:, 0].tolist() == [0, 2, 1, 0, 2, 1]
    # more distinct label buckets than c_sel: four in repetition 0
    y2 = y.copy()
    y2[3, 0] = 9
    sel2 = np.asarray(jref.mach_select_buckets_ref(*_j(proxy, y2), b, c_sel))
    got_sel = ops.mach_select_buckets(*_t(proxy, y2), num_buckets=b,
                                      c_sel=c_sel)
    np.testing.assert_array_equal(got_sel.numpy(), sel2)
    left_out = [int(v) for v in set(y2[:, 0]) - set(sel2[0].tolist())]
    assert left_out
    pos2 = ref.label_positions(got_sel, torch.from_numpy(y2))
    for i in range(y2.shape[0]):
        if int(y2[i, 0]) in left_out:
            assert int(pos2[i, 0]) == 0
    want = jref.mach_fused_xent_selected_ref(*_j(h, w, y2, sel2), b,
                                             bias=jnp.asarray(bb))
    got = ops.mach_fused_xent(*_t(h, w, y2), num_buckets=b,
                              bias=torch.from_numpy(bb),
                              bucket_select=(c_sel, 1),
                              bucket_proxy=torch.from_numpy(proxy))
    _close(got, want)


# ---------------------------------------------------------------------------
# heads and the trainer, against the JAX package's
# ---------------------------------------------------------------------------

def _linear_heads(k=500, b=32, r=4, d=16):
    jcfg = jm.MACHConfig(k, b, r)
    jhead = jm.MACHLinear(jcfg, d, fused=True)
    thead = tm.MACHLinear(tm.MACHConfig(k, b, r), d, fused=True)
    jp = jhead.init(jax.random.key(0))
    jp["b"] = jax.random.normal(jax.random.key(1), jp["b"].shape) * 0.1
    tp = convert.convert_params(thead, jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jhead, jp, thead, tp


def test_heads_bucket_proxy_and_selected_fused_loss_match_jax():
    jhead, jp, thead, tp = _linear_heads()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(10, 16)).astype(np.float32)
    y = rng.integers(0, 500, size=(10,)).astype(np.int32)
    indptr, indices, values = _csr(rng, 10, 16, 5)
    jsb = types.SimpleNamespace(indptr=jnp.asarray(indptr),
                                indices=jnp.asarray(indices),
                                values=jnp.asarray(values), nnz_max=5)
    tsb = SparseBatch(*_t(indptr, indices, values), 16, 5)
    with jax_reference():
        for jx, tx in ((jnp.asarray(x), torch.from_numpy(x)), (jsb, tsb)):
            jproxy = jhead.bucket_proxy_scores(jp, jx)
            tproxy = thead.bucket_proxy_scores(tp, tx)
            assert tproxy.shape == (4, 32)
            _close(tproxy, jproxy, rtol=1e-6,
                   atol=1e-6 * float(jnp.abs(jproxy).max()))
            full = float(thead.fused_loss(tp, tx, torch.from_numpy(y)))
            for proxy in (None, tproxy):
                jl, jg = jax.value_and_grad(
                    lambda p: jhead.fused_loss(
                        p, jx, jnp.asarray(y), bucket_select=(8, 3),
                        bucket_proxy=None if proxy is None else jproxy))(jp)
                leaves = {k: v.clone().requires_grad_(True)
                          for k, v in tp.items()}
                tl = thead.fused_loss(leaves, tx, torch.from_numpy(y),
                                      bucket_select=(8, 3),
                                      bucket_proxy=proxy)
                _close(tl, jl)
                assert float(tl.detach()) <= full + 1e-6
                tl.backward()
                for key in ("w", "b"):
                    _close(leaves[key].grad, jg[key])
    # the logits alias of the JAX package's pre-MACHHead name
    assert torch.equal(thead.logits(tp, torch.from_numpy(x)),
                       thead.head_logits(tp, torch.from_numpy(x)))


def test_output_head_bucket_proxy_and_selected_loss_match_jax():
    jcfg, tcfg = jm.MACHConfig(500, 32, 4), tm.MACHConfig(500, 32, 4)
    jhead, thead = jm.MACHOutputHead(jcfg, 16), tm.MACHOutputHead(tcfg, 16)
    jp = jhead.init(jax.random.key(3))
    tp = convert.convert_params(thead, {"kernel": np.asarray(jp["kernel"])},
                                device="cpu")
    rng = np.random.default_rng(5)
    h = rng.normal(size=(6, 3, 16)).astype(np.float32)
    y = rng.integers(0, 500, size=(6, 3)).astype(np.int32)
    with jax_reference():
        jproxy = jhead.bucket_proxy_scores(jp, jnp.asarray(h))
        jl = jhead.fused_loss(jp, jnp.asarray(h), jnp.asarray(y),
                              bucket_select=(8, 3), bucket_proxy=jproxy)
    tproxy = thead.bucket_proxy_scores(tp, torch.from_numpy(h))
    _close(tproxy, jproxy, rtol=1e-6,
           atol=1e-6 * float(jnp.abs(jproxy).max()))
    tl = thead.fused_loss(tp, torch.from_numpy(h), torch.from_numpy(y),
                          bucket_select=(8, 3), bucket_proxy=tproxy)
    _close(tl, jl)


class _HeadModel:
    """A MACHLinear trained through its fused loss with selection, as a
    (params, batch) -> (loss, metrics) model whose ``cfg`` carries
    ``mach_bucket_select`` (the trainer reads its refresh cadence)."""

    def __init__(self, head, bucket_select):
        self.head = head
        self.cfg = types.SimpleNamespace(mach_bucket_select=bucket_select)

    def loss(self, params, batch):
        loss = self.head.fused_loss(params, batch["x"], batch["y"],
                                    bucket_select=self.cfg.mach_bucket_select,
                                    bucket_proxy=batch.get("bucket_proxy"))
        return loss, {"loss": loss}


class _Stream:
    def __init__(self, batches, to):
        self.batches, self.to = batches, to

    def batch_at(self, step):
        x, y = self.batches[step]
        return {"x": self.to(x), "y": self.to(y)}


def test_trainer_refreshes_the_proxy_and_matches_jax():
    """Trainer(bucket_proxy_fn) with refresh_every = 3: the proxy runs on
    steps 0 and 3 and reaches every step's loss; five AdamW steps agree
    with the JAX Trainer's."""
    steps, n, select = 5, 32, (8, 3)
    jhead, jp, thead, tp = _linear_heads(k=1024, b=32, r=4, d=24)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(steps):
        x = np.abs(rng.normal(size=(n, 24))).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        batches.append((x, rng.integers(0, 1024, size=n).astype(np.int32)))
    tc = dict(schedule="constant", peak_lr=0.05, log_every=100)
    calls = {"jax": 0, "port": 0}
    seen = []

    with jax_reference():
        def jproxy(params, batch):
            calls["jax"] += 1
            return jhead.bucket_proxy_scores(params, batch["x"])

        jtr = jtrainer.Trainer(_HeadModel(jhead, select),
                               jtrainer.TrainConfig(**tc),
                               bucket_proxy_fn=jproxy)
        jstate = jtr.fit(jax_new_train_state(jp, jtr.opt),
                         _Stream(batches, jnp.asarray), steps, log=None)

    model = _HeadModel(thead, select)

    def tproxy(params, batch):
        calls["port"] += 1
        assert not torch.is_grad_enabled()
        return thead.bucket_proxy_scores(params, batch["x"])

    def spy_loss(params, batch):
        seen.append(batch["bucket_proxy"])
        return model.loss(params, batch)

    tr = Trainer(model, TrainConfig(**tc), loss_fn=spy_loss,
                 bucket_proxy_fn=tproxy)
    state = tr.fit(new_train_state(tp, tr.opt),
                   _Stream(batches, torch.from_numpy), steps, log=None)
    assert calls == {"jax": 2, "port": 2}            # steps 0 and 3
    assert len(seen) == steps and seen[0] is seen[2] and seen[3] is seen[4]
    assert seen[2] is not seen[3]
    assert state.step == steps == int(jstate.step)
    for key in ("w", "b"):
        np.testing.assert_allclose(state.params[key].numpy(),
                                   np.asarray(jstate.params[key]),
                                   rtol=1e-4, atol=1e-6)

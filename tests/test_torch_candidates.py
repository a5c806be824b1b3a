"""Port's count-min candidate decode (``ops.mach_topk_candidates``,
``ops.mach_topk(candidate_mode=...)``, CPU paths) vs the JAX package.

The JAX side runs its TPU kernels ``bucket_topm_pallas`` and
``mach_candidate_topk_pallas`` in interpret mode, its pure path
``mach_candidate_topk`` (table mode) and its oracle
``ref.mach_candidate_topk_ref``; ``repro.kernels.ops`` does not import
under jax 0.9.0, so the kernel module is imported directly.

Tolerances: bucket ids and tau exactly (ties to the lowest bucket id, as
``lax.top_k``).  Candidate values at rtol 1e-6 / atol 1e-7 (the JAX side
averages with ``jnp.mean`` and maps affinely in XLA's order; the port
sums in r order and maps after selection, as its streaming op does);
filtered (-inf, -1) slots in the same positions; class ids equal except
where the two picks' scores tie within that tolerance: the port ranks
ties by lowest class id, the TPU kernel by pool position.  Exact mode
(m=B, t=R) must equal the port's streaming top-k bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core import mach as jm
from repro.kernels import ref as jref
from repro.kernels.mach_candidates import (bucket_topm as jax_bucket_topm,
                                           bucket_topm_pallas,
                                           decode_penalty_topk,
                                           mach_candidate_topk as jax_candidates,
                                           mach_candidate_topk_pallas)
from repro_torch import convert
from repro_torch.core import estimators as te
from repro_torch.core import hashing as th
from repro_torch.core import mach as tm
from repro_torch.kernels import mach_candidates as tc
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mach_topk import unbiased_affine
from torch_cases import dyadic_meta, random_meta

ESTIMATORS = ("unbiased", "min", "median")
TOL = {"rtol": 1e-6, "atol": 1e-7}


def _family(k_cls, b, r, kind="mult_shift", seed=0):
    cls = jh.MultShiftFamily if kind == "mult_shift" else jh.CarterWegmanFamily
    fam = cls(b, r, seed)
    tab = fam.table_np(k_cls)
    return fam, tab, jh.inverted_table_np(tab, b)


def _port(meta, inv, k_cls, k, m, t, est, fam=None, tab=None):
    """ops.mach_topk_candidates on CPU tensors, inline hash when ``fam``
    is given, else the table; returns numpy (val, idx)."""
    kw = ({"inline_coeffs": torch.from_numpy(fam.coeffs().astype(np.int64)),
           "inline_shift": fam.shift} if fam is not None else {})
    v, i = ops.mach_topk_candidates(
        torch.from_numpy(meta), None if tab is None else torch.from_numpy(tab),
        inverted=torch.from_numpy(inv), num_classes=k_cls, k=k, m=m, t=t,
        estimator=est, **kw)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    return v.numpy(), i.numpy()


def _scores(meta, tab, est):
    return np.asarray(jref.mach_estimator_scores_ref(jnp.asarray(meta),
                                                     jnp.asarray(tab), est))


def _assert_close(tv, ti, jv, ji, scores):
    """Dead slots equal in position; live values within TOL; ids equal
    except on near-ties of ``scores`` (N, K); no duplicate live id."""
    jv, ji = np.asarray(jv), np.asarray(ji)
    dead = tv == -np.inf
    np.testing.assert_array_equal(dead, jv == -np.inf)
    np.testing.assert_array_equal(ti[dead], -1)
    np.testing.assert_array_equal(ji[dead], -1)
    np.testing.assert_allclose(tv[~dead], jv[~dead], **TOL)
    for row, ids in enumerate(ti):
        live = ids[~dead[row]].tolist()
        assert len(set(live)) == len(live)
    diff = (ti != ji) & ~dead
    rows = np.nonzero(diff)[0]
    np.testing.assert_allclose(scores[rows, ti[diff]], jv[diff], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# kernel 7's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 5, 16])
@pytest.mark.parametrize("inputs", ["ties", "random"])
def test_bucket_topm_matches_jax(inputs, m):
    """ids and tau exactly, ties to the lowest bucket id (coarse dyadic
    values tie in bulk)."""
    if inputs == "ties":
        meta = (np.random.default_rng(m).integers(0, 5, (5, 6, 16)) / 4
                ).astype(np.float32)
    else:
        meta = random_meta(5, 6, 16, seed=m)
    tau, ids = tc.bucket_topm(torch.from_numpy(meta), m)
    assert tau.dtype == torch.float32 and ids.dtype == torch.int32
    assert tuple(ids.shape) == (5, 6, m)
    for jt, ji in (jax_bucket_topm(jnp.asarray(meta), m),
                   bucket_topm_pallas(jnp.asarray(meta), m, interpret=True)):
        np.testing.assert_array_equal(tau.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# kernel 8's plain version vs the TPU kernel, the pure path and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("estimator", ESTIMATORS)
@pytest.mark.parametrize("m,t", [(4, 1), (6, 2), (16, 6)])
def test_candidates_match_pallas_kernel(m, t, estimator):
    k_cls, b, r, n, k = 1000, 16, 6, 4, 9
    fam, tab, inv = _family(k_cls, b, r)
    meta = random_meta(n, r, b, seed=m + t)
    jv, ji = mach_candidate_topk_pallas(
        jnp.asarray(meta), jnp.asarray(inv), num_classes=k_cls, k=k, m=m, t=t,
        estimator=estimator, inline_coeffs=jnp.asarray(fam.coeffs()),
        inline_shift=fam.shift, interpret=True)
    tv, ti = _port(meta, inv, k_cls, k, m, t, estimator, fam=fam)
    _assert_close(tv, ti, jv, ji, _scores(meta, tab, estimator))


@pytest.mark.parametrize("estimator", ESTIMATORS)
@pytest.mark.parametrize("kind", ["carter_wegman", "mult_shift"])
def test_table_mode_matches_jax_pure_path(kind, estimator):
    """Table mode against the JAX pure path, which is exact while the
    claimed count is <= its compact_cap (2048 > K here)."""
    k_cls, b, r, n, k, m, t = 1500, 16, 5, 5, 8, 5, 2
    _, tab, inv = _family(k_cls, b, r, kind, seed=2)
    meta = random_meta(n, r, b, seed=4)
    jv, ji = jax_candidates(jnp.asarray(meta), jnp.asarray(inv),
                            jnp.asarray(tab), num_classes=k_cls, k=k, m=m, t=t,
                            estimator=estimator, compact_cap=2048)
    tv, ti = _port(meta, inv, k_cls, k, m, t, estimator, tab=tab)
    _assert_close(tv, ti, jv, ji, _scores(meta, tab, estimator))


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_candidates_match_oracle(estimator):
    """Random inputs (no ties at tau): the port equals the brute-force
    oracle of both packages."""
    k_cls, b, r, n, k, m, t = 2000, 32, 6, 5, 10, 3, 2
    fam, tab, inv = _family(k_cls, b, r, seed=5)
    meta = random_meta(n, r, b, seed=6)
    jv, ji = jref.mach_candidate_topk_ref(jnp.asarray(meta), jnp.asarray(tab),
                                          k, m, t, estimator)
    scores = _scores(meta, tab, estimator)
    tv, ti = _port(meta, inv, k_cls, k, m, t, estimator, fam=fam)
    _assert_close(tv, ti, jv, ji, scores)
    ov, oi = tref.mach_candidate_topk_ref(torch.from_numpy(meta),
                                          torch.from_numpy(tab), k, m, t,
                                          estimator)
    _assert_close(ov.numpy(), oi.numpy(), jv, ji, scores)


def test_oracles_agree_on_dyadic_ties():
    """The port's oracle is the JAX oracle: on dyadic inputs with ties,
    ids exactly and values exactly (unbiased within the affine map's
    rounding)."""
    k_cls, b, r, n, k = 700, 8, 4, 6, 12
    _, tab, _ = _family(k_cls, b, r, seed=7)
    meta = dyadic_meta(n, r, b, seed=7)
    for est in ESTIMATORS:
        for m, t in ((2, 1), (3, 2), (1, 4)):
            jv, ji = jref.mach_candidate_topk_ref(
                jnp.asarray(meta), jnp.asarray(tab), k, m, t, est)
            ov, oi = tref.mach_candidate_topk_ref(
                torch.from_numpy(meta), torch.from_numpy(tab), k, m, t, est)
            np.testing.assert_array_equal(oi.numpy(), np.asarray(ji))
            np.testing.assert_allclose(ov.numpy(), np.asarray(jv), rtol=1e-6)


def test_backfill_row_with_no_t_survivor():
    """t=R, m=1 on flat-random rows: slot 0 holds the best count>=1
    candidate at its restored score, the rest is filtered."""
    k_cls, b, r, n, k = 2000, 16, 6, 8, 5
    fam, tab, inv = _family(k_cls, b, r)
    meta = random_meta(n, r, b, seed=11)
    ov, oi = jref.mach_candidate_topk_ref(jnp.asarray(meta), jnp.asarray(tab),
                                          k, 1, r)
    cv, ci = _port(meta, inv, k_cls, k, 1, r, "unbiased", fam=fam)
    _assert_close(cv, ci, ov, oi, _scores(meta, tab, "unbiased"))
    assert np.all(cv[:, 0] > -np.inf) and np.all(ci[:, 0] >= 0)
    assert np.any(cv == -np.inf)
    np.testing.assert_array_equal(ci[cv == -np.inf], -1)


def test_recall_monotone_in_m_and_t():
    """The candidate set grows with m and shrinks with t, so recall@k of
    the streaming top-k is non-decreasing in m and non-increasing in t."""
    k_cls, b, r, n, k = 3000, 32, 6, 12, 10
    fam, tab, inv = _family(k_cls, b, r)
    meta = random_meta(n, r, b, seed=23)
    _, si = ops.mach_topk(torch.from_numpy(meta), torch.from_numpy(tab),
                          num_classes=k_cls, k=k)
    si = si.numpy()

    def recall(m, t):
        _, ci = _port(meta, inv, k_cls, k, m, t, "unbiased", fam=fam)
        return np.mean([len(set(ci[i]) & set(si[i])) / k for i in range(n)])

    rec_m = [recall(m, 1) for m in (1, 2, 4, 8, 32)]
    assert all(a <= c + 1e-12 for a, c in zip(rec_m, rec_m[1:])), rec_m
    assert rec_m[-1] == 1.0
    rec_t = [recall(4, t) for t in (1, 2, 4, 6)]
    assert all(a >= c - 1e-12 for a, c in zip(rec_t, rec_t[1:])), rec_t


@pytest.mark.parametrize("estimator", ESTIMATORS)
@pytest.mark.parametrize("mode", ["table", "inline"])
@pytest.mark.parametrize("inputs", ["dyadic", "random"])
def test_exact_mode_equals_streaming(inputs, mode, estimator):
    """(m, t) = (B, R) claims every class once with count R: values and
    ids equal the streaming top-k exactly, ties included."""
    k_cls, b, r, n, k = 900, 16, 5, 7, 20
    fam, tab, inv = _family(k_cls, b, r, seed=3)
    meta = (dyadic_meta if inputs == "dyadic" else random_meta)(n, r, b, seed=9)
    hash_kw = ({"inline_coeffs": torch.from_numpy(fam.coeffs().astype(np.int64)),
                "inline_shift": fam.shift} if mode == "inline"
               else {"table": torch.from_numpy(tab)})
    sv, si = ops.mach_topk(torch.from_numpy(meta), num_classes=k_cls, k=k,
                           estimator=estimator, **hash_kw)
    cv, ci = ops.mach_topk(torch.from_numpy(meta), num_classes=k_cls, k=k,
                           estimator=estimator, candidate_mode=(b, r),
                           inverted=torch.from_numpy(inv), **hash_kw)
    assert torch.equal(cv, sv) and torch.equal(ci, si)


def test_plain_blocks_do_not_change_the_answer(monkeypatch):
    """Rows and pool entries in small blocks give the one-block answer."""
    k_cls, b, r, n, k = 1200, 16, 6, 5, 12
    fam, _, inv = _family(k_cls, b, r)
    meta = random_meta(n, r, b, seed=12)
    for est in ESTIMATORS:
        whole = _port(meta, inv, k_cls, k, 5, 2, est, fam=fam)
        monkeypatch.setattr(tc, "_PLAIN_ENTRIES", 300)
        blocked = _port(meta, inv, k_cls, k, 5, 2, est, fam=fam)
        monkeypatch.undo()
        for a, c in zip(whole, blocked):
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("estimator", ["unbiased", "min"])
@pytest.mark.parametrize("t", [1, 3])
def test_finish_equals_jax_penalty_decode(t, estimator):
    """finish_candidates maps (value, band, id) straight to the answer;
    the JAX package's penalty encoding then its decode_penalty_topk give
    the same, exactly, and the port's decode_penalty_topk is the JAX
    one.  Rows: all valid, valid then backfill, backfill only, dead
    only, one of each, valid then dead."""
    r, b, k = 4, 16, 5
    n_valid = [5, 2, 0, 0, 1, 3]
    n_back = [0, 2, 3, 0, 1, 0] if t > 1 else [0] * 6
    rng = np.random.default_rng(t)
    top = r if estimator == "unbiased" else 1.0    # scores within (-1, 1]
    sel = np.full((6, k), -np.inf, np.float32)
    band = np.zeros((6, k), np.int32)
    idx = np.full((6, k), -1, np.int32)
    for row, (nv, nb) in enumerate(zip(n_valid, n_back)):
        for lo, hi, bd in ((0, nv, 2), (nv, nv + nb, 1)):
            sel[row, lo:hi] = np.sort(rng.uniform(0.1, top, hi - lo))[::-1]
            band[row, lo:hi] = bd
        idx[row, :nv + nb] = rng.choice(1000, nv + nb, replace=False)
    sel_t, band_t, idx_t = map(torch.from_numpy, (sel, band, idx))
    got_v, got_i = tc.finish_candidates(sel_t, band_t, idx_t, r, b, estimator)
    s = unbiased_affine(sel_t, r, b) if estimator == "unbiased" else sel_t
    enc = torch.where(band_t == 2, s,
                      torch.where(band_t == 1, s - tc.OFFSET, tc.NEG_INF))
    want_v, want_i = decode_penalty_topk(jnp.asarray(enc.numpy()),
                                         jnp.asarray(idx), t)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    port_v, port_i = tc.decode_penalty_topk(enc, idx_t, t)
    np.testing.assert_array_equal(port_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(port_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("mode", ["table", "inline"])
def test_pool_gathers_counts_the_kernel_loop(mode):
    """pool_gathers equals an entry-by-entry walk of kernel 8's loop:
    repetitions in order, stopping at a member one below the chunk's
    repetition r0 or at r0 when it is no member there."""
    k_cls, b, r, n, m = 300, 8, 4, 3, 3
    fam, tab, inv = _family(k_cls, b, r, seed=4)
    meta = random_meta(n, r, b, seed=5)
    tau, ids = tc.bucket_topm(torch.from_numpy(meta), m)
    hash_kw = ({"inline_coeffs": torch.from_numpy(fam.coeffs().astype(np.int64)),
                "inline_shift": fam.shift} if mode == "inline"
               else {"table": torch.from_numpy(tab)})
    got = tc.pool_gathers(torch.from_numpy(meta), tau, ids,
                          torch.from_numpy(inv), num_classes=k_cls, **hash_kw)
    tau, ids = tau.numpy(), ids.numpy()
    want = 0
    for q in range(n):
        for c in range(r * m):
            r0 = c // m
            for cls in inv[r0 * b + ids[q, r0, c % m]]:
                if not 0 <= cls < k_cls:
                    continue
                for j in range(r):
                    want += 1
                    member = meta[q, j, tab[j, cls]] >= tau[q, j]
                    if (j < r0 and member) or (j == r0 and not member):
                        break
    assert got == want


@pytest.mark.parametrize("mode", ["table", "inline"])
def test_pool_gathers_skips_chunks_past_an_all_member_repetition(mode):
    """At m = B tau is each row's minimum, so repetition 0 is all members
    and only its chunks can claim: pool_gathers counts R for each of
    their live entries (every class once a query) and nothing for the
    later repetitions' chunks, which kernel 8 skips whole."""
    k_cls, b, r, n = 300, 8, 4, 3
    fam, tab, inv = _family(k_cls, b, r, seed=4)
    meta = torch.from_numpy(random_meta(n, r, b, seed=5))
    tau, ids = tc.bucket_topm(meta, b)
    hash_kw = ({"inline_coeffs": torch.from_numpy(fam.coeffs().astype(np.int64)),
                "inline_shift": fam.shift} if mode == "inline"
               else {"table": torch.from_numpy(tab)})
    assert tc.live_repetitions(meta, tau, b).tolist() == [1] * n
    assert tc.live_repetitions(meta, tau, b - 1).tolist() == [r] * n
    got = tc.pool_gathers(meta, tau, ids, torch.from_numpy(inv),
                          num_classes=k_cls, **hash_kw)
    assert got == n * k_cls * r
    # a row whose repetition 2 alone is all members: repetitions 0-2 walk
    flat = meta.clone()
    flat[0, 2] = 0.125
    tau2, _ = tc.bucket_topm(flat, b)
    tau2[0, :2] = 1.0           # no bucket a member at repetitions 0-1
    assert tc.live_repetitions(flat, tau2, b).tolist()[0] == 3


def test_keys_round_trip():
    """The plain version's int64 keys order (band, value, -class id) and
    decode back, -0.0 as +0.0."""
    band = torch.tensor([2, 2, 2, 1, 1, 2, 0])
    sel = torch.tensor([0.5, 0.5, -0.25, 3.0, -0.0, 0.0, 7.0])
    cls = torch.tensor([7, 3, 9, 1, 4, 5, 2])
    keys = tc._pack_keys(band, sel, cls)
    order = torch.argsort(keys, descending=True).tolist()
    assert order == [1, 0, 5, 2, 3, 4, 6]
    v, bd, i = tc._unpack_keys(keys)
    np.testing.assert_array_equal(v.numpy()[:6], [0.5, 0.5, -0.25, 3.0, 0.0, 0.0])
    np.testing.assert_array_equal(bd.numpy(), band.numpy())
    np.testing.assert_array_equal(i.numpy(), [7, 3, 9, 1, 4, 5, -1])
    assert v[6] == -torch.inf


# ---------------------------------------------------------------------------
# the entry points: ops, estimators, MACHHead
# ---------------------------------------------------------------------------

def test_leading_dims_through_ops_and_predict_topk():
    k_cls, b, r = 1000, 32, 8
    fam, tab, inv = _family(k_cls, b, r)
    meta = random_meta(6, r, b, seed=4)
    flat_v, flat_i = _port(meta, inv, k_cls, 5, 6, 2, "median", tab=tab)
    tab_t, inv_t = torch.from_numpy(tab), torch.from_numpy(inv)
    v, i = ops.mach_topk(torch.from_numpy(meta).reshape(2, 3, r, b), tab_t,
                         num_classes=k_cls, k=5, estimator="median",
                         candidate_mode=(6, 2), inverted=inv_t)
    assert tuple(v.shape) == tuple(i.shape) == (2, 3, 5)
    np.testing.assert_array_equal(v.reshape(6, 5).numpy(), flat_v)
    np.testing.assert_array_equal(i.reshape(6, 5).numpy(), flat_i)
    rmeta = torch.from_numpy(meta).permute(1, 0, 2).reshape(r, 2, 3, b)
    v, i = te.predict_topk(rmeta, tab_t, 5, "median", candidate_mode=(6, 2),
                           inverted=inv_t)
    np.testing.assert_array_equal(i.reshape(6, 5).numpy(), flat_i)
    sv, si = te.predict_topk(rmeta, tab_t, 5, "median", candidate_mode="exact")
    v, i = te.predict_topk(rmeta, tab_t, 5, "median", candidate_mode=(b, r),
                           inverted=inv_t)
    assert torch.equal(v, sv) and torch.equal(i, si)


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_mach_linear_predict_candidate_mode(estimator):
    """MACHLinear.predict(candidate_mode=(B, R)) on params converted from
    the JAX head equals the JAX head's predict, up to near-ties, and the
    port's streaming top-1 exactly."""
    k_cls, b, r, dim = 600, 16, 5, 24
    jcfg = jm.MACHConfig(k_cls, b, r, estimator=estimator)
    tcfg = tm.MACHConfig(k_cls, b, r, estimator=estimator)
    jhead, thead = jm.MACHLinear(jcfg, dim), tm.MACHLinear(tcfg, dim)
    jp = jhead.init(jax.random.key(0))
    tp = convert.convert_params(thead, jax.tree.map(np.asarray, jp),
                                device="cpu")
    x = np.random.default_rng(1).normal(size=(9, dim)).astype(np.float32)
    want = np.asarray(jhead.predict(jp, jnp.asarray(x)))
    got = thead.predict(tp, torch.from_numpy(x), candidate_mode=(b, r)).numpy()
    scores = np.asarray(jhead.class_probs(jp, jnp.asarray(x)))
    rows = np.arange(len(want))
    np.testing.assert_allclose(scores[rows, got], scores[rows, want],
                               rtol=1e-5, atol=1e-6)
    meta = thead.meta_probs(tp, torch.from_numpy(x))
    _, top1 = te.predict_topk(meta, thead.table("cpu"), 1, estimator)
    np.testing.assert_array_equal(got, top1[:, 0].numpy())
    inv = thead.inverted_table("cpu")
    assert thead.inverted_table("cpu") is inv            # cached per device
    again = thead.predict(tp, torch.from_numpy(x), candidate_mode=(b, r),
                          inverted=inv)
    np.testing.assert_array_equal(again.numpy(), got)


def test_candidate_validation():
    k_cls, b, r = 100, 16, 2
    fam, tab, inv = _family(k_cls, b, r)
    meta = torch.from_numpy(random_meta(2, r, b, seed=0))
    inv_t = torch.from_numpy(inv)
    kw = {"inline_coeffs": torch.from_numpy(fam.coeffs().astype(np.int64)),
          "inline_shift": fam.shift}
    for bad in [dict(k=0, m=4, t=1), dict(k=5, m=0, t=1),
                dict(k=5, m=17, t=1), dict(k=5, m=4, t=3),
                dict(k=5, m=4, t=1, estimator="mode")]:
        with pytest.raises(ValueError):
            ops.mach_topk_candidates(meta, inverted=inv_t, num_classes=k_cls,
                                     **{**kw, **bad})
    with pytest.raises(ValueError, match="table or"):
        ops.mach_topk_candidates(meta, inverted=inv_t, num_classes=k_cls, k=5,
                                 m=4)
    with pytest.raises(ValueError, match="inverted"):
        ops.mach_topk_candidates(meta, inverted=inv_t[:5], num_classes=k_cls,
                                 k=5, m=4, **kw)
    with pytest.raises(ValueError, match="inverted table"):
        ops.mach_topk(meta, num_classes=k_cls, k=5, candidate_mode=(4, 1), **kw)
    with pytest.raises(ValueError, match="candidate_mode"):
        ops.mach_topk(meta, num_classes=k_cls, k=5, candidate_mode="fast",
                      inverted=inv_t, **kw)
    _, tab500, inv500 = _family(500, b, r)
    with pytest.raises(ValueError, match="largest k"):
        ops.mach_topk_candidates(meta, torch.from_numpy(tab500),
                                 inverted=torch.from_numpy(inv500),
                                 num_classes=500, k=129, m=4)
    with pytest.raises(ValueError, match="CUDA"):
        tc.mach_candidate_topk_cuda(meta, *tc.bucket_topm(meta, 4), inv_t,
                                    num_classes=k_cls, k=5, **kw)


@pytest.mark.parametrize("kind", ["carter_wegman", "mult_shift"])
def test_inverted_table_matches_jax(kind):
    jcfg = jm.MACHConfig(1000, 32, 8, hash_kind=kind)
    tcfg = tm.MACHConfig(1000, 32, 8, hash_kind=kind)
    want = np.asarray(jh.inverted_table(jcfg.table_np(), 32))
    got = th.inverted_table(tcfg.table_np(), 32, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        th.inverted_table(tcfg.table("cpu"), 32, device="cpu").numpy(), want)
    np.testing.assert_array_equal(tcfg.inverted_table(device="cpu").numpy(),
                                  np.asarray(jcfg.inverted_table()))
    np.testing.assert_array_equal(
        tcfg.inverted_table(pad_to=8, device="cpu").numpy(),
        np.asarray(jcfg.inverted_table(pad_to=8)))

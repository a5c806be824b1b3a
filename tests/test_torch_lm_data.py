"""The port's synthetic LM stream and straggler monitor against the JAX
package's ``repro.data.lm`` and ``repro.train.fault_tolerance``.

The stream draws from a ``torch.Generator`` seeded by (seed, step, host
index), so it matches JAX's in distribution, not number for number:
both plant the bigram t -> (t·31 + 7) mod V at rate ``bigram_p`` (the
rates at which a token follows its predecessor so agree within 8
binomial standard deviations), both
draw Zipf base tokens (the share of token 0 within 4 standard
deviations of the Zipf weight that is mixed in), and ``batch_at`` is a
pure function of the step.  The monitor is plain arithmetic: the same
step times flag the same steps.
"""

import math

import numpy as np
import pytest
import torch

from repro.data import lm as jlm
from repro.train.fault_tolerance import StragglerMonitor as JaxMonitor
from repro_torch.data import LMDataConfig, SyntheticLMStream
from repro_torch.train import StragglerMonitor

V, L, B = 256, 64, 32


def _planted_rate(tokens: np.ndarray) -> float:
    follow = (tokens[:, :-1].astype(np.int64) * 31 + 7) % V
    return float(np.mean(tokens[:, 1:] == follow))


def test_stream_is_stateless_and_matches_jax_in_distribution():
    cfg = LMDataConfig(vocab_size=V, seq_len=L, global_batch=B, seed=3)
    stream = SyntheticLMStream(cfg, device="cpu")
    b0 = stream.batch_at(5)["tokens"]
    assert b0.shape == (B, L + 1) and b0.dtype == torch.int32
    assert torch.equal(b0, SyntheticLMStream(cfg, device="cpu").batch_at(5)
                       ["tokens"])
    assert not torch.equal(b0, stream.batch_at(6)["tokens"])
    assert int(b0.min()) >= 0 and int(b0.max()) < V
    first = next(iter(stream))["tokens"]
    assert torch.equal(first, stream.batch_at(0)["tokens"])
    jstream = jlm.SyntheticLMStream(jlm.LMDataConfig(
        vocab_size=V, seq_len=L, global_batch=B, seed=3))
    got = np.concatenate([stream.batch_at(s)["tokens"].numpy()
                          for s in range(4)])
    want = np.concatenate([np.asarray(jstream.batch_at(s)["tokens"])
                           for s in range(4)])
    n = got[:, 1:].size
    # the follower is planted from the base token, so tokens[i+1] ==
    # f(tokens[i]) when position i+1 is planted and position i is not:
    # p·(1 − p) = 0.25, plus Zipf coincidences
    sd = math.sqrt(0.25 * 0.75 / n)
    for rate in (_planted_rate(got), _planted_rate(want)):
        assert 0.25 - 4 * sd < rate < 0.30
    assert abs(_planted_rate(got) - _planted_rate(want)) < 8 * sd
    # token 0 at the first position: a pure Zipf draw
    w = np.arange(1, V + 1, dtype=np.float64) ** -1.2
    p0 = w[0] / w.sum()
    sd0 = math.sqrt(p0 * (1 - p0) / len(got))
    for toks in (got, want):
        assert abs(np.mean(toks[:, 0] == 0) - p0) < 4 * sd0


def test_hosts_carve_disjoint_slices():
    cfg = LMDataConfig(vocab_size=V, seq_len=8, global_batch=8, seed=1)
    a = SyntheticLMStream(cfg, host_index=0, host_count=2, device="cpu")
    b = SyntheticLMStream(cfg, host_index=1, host_count=2, device="cpu")
    assert a.local_batch == b.local_batch == 4
    assert not torch.equal(a.batch_at(0)["tokens"], b.batch_at(0)["tokens"])
    with pytest.raises(ValueError, match="split"):
        SyntheticLMStream(cfg, host_count=3, device="cpu")
    feats = dict(enc_feats_dim=4, enc_len=3, prefix_feats_dim=5, prefix_len=2)
    fa, fb = (SyntheticLMStream(LMDataConfig(V, 8, 8, **feats), host_index=i,
                                host_count=2, device="cpu").batch_at(0)
              for i in (0, 1))
    assert fa["enc_feats"].shape == (4, 3, 4)
    assert fa["prefix_feats"].shape == (4, 2, 5)
    assert fa["enc_feats"].dtype == fa["prefix_feats"].dtype == torch.float32
    assert not torch.equal(fa["enc_feats"], fb["enc_feats"])


def test_straggler_monitor_matches_jax():
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 1.0, 3.0, 1.0, 0.95, 2.5, 1.0, 9.0]
    mine, theirs = StragglerMonitor(), JaxMonitor()
    flags = [mine.record(s, dt) for s, dt in enumerate(times)]
    assert flags == [theirs.record(s, dt) for s, dt in enumerate(times)]
    assert mine.flagged == theirs.flagged and any(flags)
    assert mine.mean == pytest.approx(theirs.mean, rel=1e-12)

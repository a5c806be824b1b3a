"""Deterministic synthetic LM data (the JAX package's ``data/lm.py``).

The batch at step s is a pure function of (seed, step, host index): a
restarted job resumes at step s and sees exactly the rest of the stream.
Tokens are Zipf draws with a planted bigram — token t is followed by
(t·31 + 7) mod V with probability ``bigram_p`` — so the loss of a model
that learns falls.  Draws come from a ``torch.Generator`` on the chosen
device, seeded from (seed, step, host index); they match the JAX stream
in distribution, not number for number (tests feed both packages the
same numpy batches where numbers must agree).  With the modality stubs
set, a batch also carries standard normal frontend features from the
same generator: ``enc_feats`` (B, enc_len, enc_feats_dim) for an
enc-dec model's encoder and ``prefix_feats`` (B, prefix_len,
prefix_feats_dim) for a vision prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch import resolve_device
from repro_torch.data.extreme import _generator, _zipf


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    # planted structure: token t is followed by (t*mult + off) % V w.p. p
    bigram_p: float = 0.5
    # modality stubs
    enc_feats_dim: int = 0          # >0 -> emit enc_feats (audio enc-dec)
    enc_len: int = 0
    prefix_feats_dim: int = 0       # >0 -> emit prefix_feats (vision)
    prefix_len: int = 0


class SyntheticLMStream:
    """Stateless stream: ``batch_at(step)`` for any step, plus iterator
    sugar.  Per-host sharding: (host_index, host_count) carve a disjoint
    slice of the global batch.  Batches are {"tokens": (B, L+1) int32}
    on ``device`` (default ``cuda``), plus float32 ``enc_feats`` /
    ``prefix_feats`` where the config asks for them."""

    def __init__(self, cfg: LMDataConfig, host_index: int = 0,
                 host_count: int = 1, device=None):
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"over {host_count} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self.device = resolve_device(device)
        self._probs = _zipf(cfg.vocab_size, cfg.zipf_a, self.device)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        gen = _generator(self.device, cfg.seed, step, self.host_index)
        b, l = self.local_batch, cfg.seq_len
        base = torch.multinomial(self._probs, b * (l + 1), replacement=True,
                                 generator=gen).reshape(b, l + 1)
        # plant bigram structure: with prob p, token[i+1] = f(token[i])
        follow = (base[:, :-1] * 31 + 7) % cfg.vocab_size
        use = torch.rand(follow.shape, generator=gen,
                         device=self.device) < cfg.bigram_p
        tokens = torch.cat([base[:, :1], torch.where(use, follow, base[:, 1:])],
                           dim=1)
        batch = {"tokens": tokens.to(torch.int32)}
        for key, length, dim in (("enc_feats", cfg.enc_len, cfg.enc_feats_dim),
                                 ("prefix_feats", cfg.prefix_len,
                                  cfg.prefix_feats_dim)):
            if dim:
                batch[key] = torch.randn((b, length, dim), generator=gen,
                                         device=self.device)
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

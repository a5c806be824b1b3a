"""Serve a small LM with continuous batching and fused MACH decode (the
JAX package's ``examples/serve_lm.py``).

Builds a reduced recurrentgemma-family model (an extreme head would be
silly at toy scale, so V=4096, B=256, R=6), submits typed ``Request``s
of very different lengths, and serves them with the slot engine:
per-request prefill into a fixed 4-slot decode pool, every step
advancing all live slots through the streaming top-k kernel, which never
forms the (batch, V) logits.  Short requests free their slot the moment
they finish and queued requests are admitted into it, so
``metrics.occupancy`` stays high on a ragged workload.

    python -m repro_torch.examples.serve_lm                     # cuda
    python -m repro_torch.examples.serve_lm --device cpu
    python -m repro_torch.examples.serve_lm --device cpu --page-size 16
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core.mach import MACHConfig
from repro_torch.models import LanguageModel, ModelConfig
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serving import (Request, SamplingParams, ServeConfig,
                                 ServingEngine)

PROMPTS = ([12, 99, 1034, 7], [5, 6], [2048, 77, 300, 41, 18, 9], [1, 2, 3],
           [400, 500])
# ragged per-request budgets: short ones free their slot early and the
# 5th prompt is admitted mid-decode (continuous batching)
BUDGETS = (16, 4, 16, 6, 16)


def model_config(page_size: int) -> ModelConfig:
    # the paged demo swaps the local-attention block (its O(window) ring
    # cache never pages) for full attention, so the page pool carries KV
    attn_kind = "attn" if page_size else "attn_local"
    return ModelConfig(
        name="serve-demo", family="hybrid",
        num_layers=6, d_model=256, num_heads=4, num_kv_heads=1,
        d_ff=512, vocab_size=4096,
        block_pattern=("rglru", "rglru", attn_kind), local_window=64,
        rnn_width=256, activation="geglu",
        mach=MACHConfig(4096, 256, 6),
        dtype=torch.float32, scan_layers=False, remat="none",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: tokens per page (0: contiguous "
                         "per-slot strips)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="shared KV page-pool size (0: derive "
                         "slots * ceil(max_len / page_size))")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = LanguageModel(model_config(args.page_size))
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params, MACH head B=256 R=6 over "
          f"V=4096 (decode never forms the (batch, V) logits)")

    def engine(**kw):
        return ServingEngine(model, params, ServeConfig(
            max_len=128, num_slots=4, max_new_tokens=16,
            page_size=args.page_size, num_pages=args.num_pages, **kw))

    greedy = engine()
    for p, n in zip(PROMPTS, BUDGETS):
        greedy.submit(Request(prompt=p, max_new_tokens=n))
    t0 = time.perf_counter()
    outs = greedy.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for p, r in zip(PROMPTS, outs):
        print(f"prompt {p} -> {list(r.tokens)} ({r.finish_reason}, "
              f"{r.latency_steps} ticks)")
    m = greedy.metrics
    print(f"\n{len(PROMPTS)} requests, {m.tokens_generated} tokens in "
          f"{dt:.1f}s ({m.tokens_generated / dt:.1f} tok/s on {device}, "
          f"greedy, {m.decode_steps} decode steps over 4 slots, "
          f"occupancy {m.occupancy:.2f})")
    if args.page_size:
        print(f"page pool: {m.num_pages} pages x {args.page_size} tokens, "
              f"peak {m.pages_peak} reserved, "
              f"{m.reservation_failures} reservation stalls")

    # sampled decoding: per-request temperature / top-k / seed, still on
    # the fused streaming top-k path — an explicit seed makes a request's
    # continuation independent of its batch neighbours and slot
    sampler = engine(top_k=16, seed=0)
    for i, p in enumerate(PROMPTS[:4]):
        sampler.submit(Request(prompt=p, sampling=SamplingParams(
            temperature=0.7 + 0.1 * i, top_k=8, seed=100 + i)))
    for p, r in zip(PROMPTS, sampler.run()):
        print(f"sampled {p} -> {list(r.tokens)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

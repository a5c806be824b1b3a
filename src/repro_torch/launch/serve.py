"""Serving entry point — continuous-batching inference on one device,
or with ``--local`` on each rank of a mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 6 --slots 4 --max-new 12
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch tinyllama-1.1b --page-size 16          # the paged KV cache
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch seamless-m4t-large-v2          # enc-dec: 8 audio frames each
    PYTHONPATH=src python -m repro_torch.launch.serve --full    # on a GPU

Smoke config unless ``--full``; weights are random, drawn from
``--seed``.  Runs on ``cuda`` unless ``--device`` says otherwise.  An
enc-dec model's requests carry 8 frames of audio features, a vision
model's its patch features (the frontends are stubs), as in the JAX
driver.
``--scheduler lockstep`` runs the chunked baseline (contiguous caches
only); ``--page-size`` pages the linear KV caches (``--num-pages`` sizes
the shared pool).

``--local`` places the params on a mesh of the launched world
(``launch/train.py``'s ``process_group``) by the JAX entry point's rules
(``ShardingRules(fsdp=False, sp=False)``), and every rank's engine
serves the same requests on the gathered params; rank 0 prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import process_group
from repro_torch.models import LanguageModel
from repro_torch.models.frontends import AUDIO_FEATURE_DIM, VISION_FEATURE_DIM
from repro_torch.serving import (Request, SamplingParams, ServeConfig,
                                 ServingEngine)
from repro_torch.serving.engine import SCHEDULERS
from repro_torch.sharding import (ShardingRules, activate, gather,
                                  params_shardings, place)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--local", "--local-mesh", action="store_true",
                    help="params placed on a mesh of the launched world "
                         "(--local-mesh: the spelling for torchrun's "
                         "command line)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=6)
    # scheduler knobs (ServeConfig)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode-pool width (concurrent requests)")
    ap.add_argument("--max-len", type=int, default=64,
                    help="per-slot cache capacity")
    ap.add_argument("--max-new", type=int, default=12,
                    help="default per-request max_new_tokens")
    ap.add_argument("--scheduler", choices=SCHEDULERS, default="continuous")
    ap.add_argument("--eos", type=int, default=-1,
                    help="EOS token id (-1: never stop early)")
    ap.add_argument("--temperature", type=float, default=None,
                    help="engine-wide sampling default (None: greedy)")
    ap.add_argument("--top-k", type=int, default=50,
                    help="fused-kernel candidate cap")
    ap.add_argument("--estimator", choices=("unbiased", "min", "median"),
                    default=None, help="per-request MACH estimator override")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: tokens per page (0: contiguous "
                         "per-slot strips)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="shared KV page-pool size (0: derive "
                         "slots * ceil(max_len / page_size))")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = LanguageModel(get_config(args.arch, smoke=args.smoke))
    if not args.local:
        return _serve(args, device, model, _params(args, model, device), print)
    with process_group(device):
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_local_mesh(device=device)
        rules = ShardingRules(fsdp=False, sp=False)
        with activate(mesh, rules):
            params = _params(args, model, device)
            params = gather(place(params, params_shardings(
                mesh, rules, model.param_axes(), params)))
            return _serve(args, device, model, params,
                          print if torch.distributed.get_rank() == 0
                          else lambda *a: None)


def _params(args, model, device) -> dict:
    return model.init(torch.Generator(device=device).manual_seed(args.seed),
                      device=device)


def _serve(args, device, model, params, log) -> int:
    cfg = model.cfg
    engine = ServingEngine(model, params,
                           ServeConfig(max_len=args.max_len,
                                       num_slots=args.slots,
                                       max_new_tokens=args.max_new,
                                       eos_id=args.eos,
                                       temperature=args.temperature,
                                       top_k=args.top_k,
                                       seed=args.seed,
                                       scheduler=args.scheduler,
                                       page_size=args.page_size,
                                       num_pages=args.num_pages))
    rng = np.random.default_rng(args.seed)
    feats = {}
    if cfg.num_encoder_layers:
        feats["enc_feats"] = rng.standard_normal(
            (8, AUDIO_FEATURE_DIM)).astype(np.float32)
    if cfg.frontend == "vision":
        feats["prefix_feats"] = rng.standard_normal(
            (cfg.num_prefix_tokens, VISION_FEATURE_DIM)).astype(np.float32)
    sampling = SamplingParams(estimator=args.estimator)
    for _ in range(args.requests):
        plen = int(rng.integers(2, 8))
        engine.submit(Request(
            prompt=rng.integers(1, cfg.vocab_size, plen).tolist(),
            sampling=sampling, **feats))
    t0 = time.perf_counter()
    outs = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for r in outs:
        log(f"request {r.request_id} ({r.finish_reason}, "
            f"{r.latency_steps} ticks): {list(r.tokens)}")
    m = engine.metrics
    log(f"{len(outs)} requests on {device}, "
        f"{m.tokens_generated / dt:.1f} tok/s, "
        f"{m.decode_steps} decode steps, occupancy {m.occupancy:.2f}")
    if args.page_size:
        log(f"page pool: {m.num_pages} pages x {args.page_size} tokens, "
            f"peak {m.pages_peak} reserved, "
            f"{m.reservation_failures} reservation failures")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

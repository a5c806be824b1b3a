"""Named variants of five dry-run cells and their roofline deltas — the
counterpart of the JAX package's ``repro/launch/perf.py``.

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --cell mistral_train --variant base

Each variant is a (config transform, rules override) pair lowered
through the port's dry run (``dryrun.lower_cell``: rank 0 of the
production mesh on fake tensors); results go to
``artifacts/perf_torch/<cell>__<variant>.json``.  A variant the port
refuses (``mach_sp``, ``sp_on``: ``Trainer`` refuses ``rules.sp``)
reports the refusal.  Every figure is arithmetic on the H100 data-sheet
constants (``launch/mesh.py``), not a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core.mach import MACHConfig
from repro_torch.launch import dryrun as dr

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "perf_torch")


def lower_variant(arch: str, shape: str, *, multi_pod=False, mach="auto",
                  cfg_updates=None, fsdp=True, sp=None,
                  mach_pod_parallel=False, micro=None, top_bytes=0) -> dict:
    """One variant's dry run: the roofline inputs, the collectives, the
    memory record, and ``top_bytes`` sites when asked; ``refused`` (the
    port's message) where the cell fails."""
    spec = None
    if micro is not None:
        spec = dict(dr.SHAPES[shape], num_microbatches=micro)
    res = dr.lower_cell(arch, shape, multi_pod, fsdp=fsdp, sp=sp, mach=mach,
                        spec=spec, top_bytes=top_bytes,
                        cfg_updates=cfg_updates,
                        mach_pod_parallel=mach_pod_parallel)
    if not res.ok:
        return {"refused": res.reason}
    d = res.data
    out = {
        "flops_dev": d["cost"]["flops_per_device"],
        "bytes_dev": d["cost"]["bytes_accessed_per_device"],
        "coll_wire": sum(v["wire_bytes"] for v in d["collectives"].values()),
        "collectives": d["collectives"],
        "compute_s": d["roofline"]["compute_s"],
        "memory_s": d["roofline"]["memory_s"],
        "collective_s": d["roofline"]["collective_s"],
        "memory": d["memory"],
    }
    if top_bytes:
        out["top_bytes"] = d["top_bytes"]
    return out


def report(cell, variant, r):
    os.makedirs(ART, exist_ok=True)
    with open(os.path.join(ART, f"{cell}__{variant}.json"), "w") as f:
        json.dump(r, f, indent=1)
    if "refused" in r:
        print(f"{cell} [{variant}]: refused by the port: {r['refused']}",
              flush=True)
        return
    m = r["memory"]
    print(f"{cell} [{variant}]: compute={r['compute_s']:.2f}s "
          f"memory={r['memory_s']:.2f}s coll={r['collective_s']:.2f}s | "
          f"args={m['per_device_argument_bytes']/2**30:.1f}G "
          f"peak={m['per_device_peak_bytes']/2**30:.1f}G "
          f"init={m['init_peak_bytes']/2**30:.1f}G "
          f"fits={m['fits_hbm']} (H100 data-sheet arithmetic)", flush=True)
    for k, v in r["collectives"].items():
        print(f"    {k}: n={v['count']:.0f} wire={v['wire_bytes']/1e9:.1f}GB")


VARIANTS = {
    "paligemma_train": (dict(arch="paligemma-3b", shape="train_4k"), {
        "oaa_head": dict(mach="off"),                 # paper's baseline
        "mach_head": dict(mach="auto"),               # paper technique
        "mach_sp": dict(mach="auto", sp=True),
        "mach_pod_parallel": dict(mach="auto", multi_pod=True,
                                  mach_pod_parallel=True),
        "mach_multipod": dict(mach="auto", multi_pod=True),
    }),
    "mistral_train": (dict(arch="mistral-large-123b", shape="train_4k"), {
        "base": dict(top_bytes=12),
        "no_sp": dict(sp=False),
        "micro8": dict(micro=8),
        "micro8_nosp": dict(micro=8, sp=False),
        "final_top": dict(micro=8, sp=False, top_bytes=14),
        "sp_on": dict(sp=True, top_bytes=12),
    }),
    "qwen_train": (dict(arch="qwen2-moe-a2.7b", shape="train_4k"), {
        "oaa_head": dict(mach="off"),
        "mach_head": dict(mach="auto"),
        "mach_B4096_R4": dict(mach="auto", cfg_updates=dict(
            mach=MACHConfig(151936, 4096, 4))),
    }),
    "paligemma_decode": (dict(arch="paligemma-3b", shape="decode_32k"), {
        "oaa_head": dict(mach="off"),
        "mach_head": dict(mach="auto"),
    }),
    "mixtral_prefill": (dict(arch="mixtral-8x22b", shape="prefill_32k"), {
        "base": dict(top_bytes=12),
        "group4096": dict(cfg_updates=dict(moe_group_size=4096)),
        "group8192": dict(cfg_updates=dict(moe_group_size=8192)),
        "bigchunks": dict(cfg_updates=dict(chunk_q=1024, chunk_k=2048)),
        "group512": dict(cfg_updates=dict(moe_group_size=512)),
        "final_top": dict(cfg_updates=dict(moe_group_size=512),
                          top_bytes=14),
        "ep_pad16": dict(cfg_updates=dict(moe_group_size=512,
                                          num_experts=16)),
    }),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--variant", required=True)
    args = ap.parse_args(argv)
    kw, variants = VARIANTS[args.cell]
    if args.variant not in variants:
        ap.error(f"--variant must be one of {sorted(variants)}")
    report(args.cell, args.variant,
           lower_variant(**kw, **variants[args.variant]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

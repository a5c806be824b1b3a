"""How far one sLSTM block of xlstm-350m amplifies a small input
difference along its scan, at the reference's recurrent weights and at
``r`` scaled by 1/sqrt(hd) (the scale ``chip_smoke.py`` holds the block
at over 2,048 tokens).

One block at xlstm-350m's widths (d = 1,024, 4 heads, hd = 256), float32,
seeded random weights as ``init_slstm_block`` draws them, on N(0, 1)
inputs of 2,048 tokens; the inputs again with a relative perturbation of
1e-7.  Prints, for each scale, the relative L2 difference of the two
outputs at a few steps.  Where it grows to O(1), two computations that
sum in other orders (a card and the CPU, a prefill and a decode step)
part over a long scan; where it stays near the perturbation, they agree.
Runs on the CPU in a few seconds:

    PYTHONPATH=src python3 tools/slstm_sensitivity.py
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.models import xlstm

STEPS = (10, 100, 500, 1000, 2047)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=2048)
    args = ap.parse_args()
    cfg = get_config("xlstm-350m")
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    p = xlstm.init_slstm_block(torch.Generator().manual_seed(0), d, h,
                               device="cpu")
    x = torch.randn((1, args.tokens, d),
                    generator=torch.Generator().manual_seed(1))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    x2 = x * (1 + 1e-7 * noise)
    for label, scale in (("reference r", 1.0), ("r / sqrt(hd)", hd ** -0.5)):
        q = dict(p, r={"kernel": p["r"]["kernel"] * scale})
        y1, _ = xlstm.apply_slstm_block(q, x)
        y2, _ = xlstm.apply_slstm_block(q, x2)
        rel = {t: float((y1[0, t] - y2[0, t]).norm() / y1[0, t].norm())
               for t in STEPS if t < args.tokens}
        print(f"sLSTM block (d={d}, {h} heads, float32), {label}: relative "
              f"output difference after a 1e-7 input perturbation, by step: "
              + ", ".join(f"{t}: {v:.2e}" for t, v in rel.items()))


if __name__ == "__main__":
    main()

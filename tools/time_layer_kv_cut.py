"""One tinyllama-1.1b decoder layer forward + backward (bf16, 2 x 4,096
tokens) at rank 0's shapes of the decoder split n ways (n = 1, 2, 4, 8;
``chip_smoke._md_rank_block`` on a world-1 NCCL mesh), with the rank's
kv heads taken three ways, in turns A B C C B A (CUDA events, ms):
  A  k and v whole, sliced to the kv heads as a view by
     ``apply_block(split=)``'s ``kv`` (the port's path where k and v are
     replicated on ``model``);
  B  k and v cut to those heads once, outside the timed call, kv=None
     (a rank's own shards, where k and v are split);
  C  k and v whole, cut with a contiguous copy inside the timed call.
Then the k projection alone, forward + backward, on the view and on a
contiguous copy.  Needs one card:

    PYTHONPATH=src python tools/time_layer_kv_cut.py
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sharding import BlockSplit  # noqa: E402


def _cut(params, k0, k1):
    """``params`` with k and v cut to kv heads [k0, k1), contiguous."""
    attn = dict(params["attn"], **{
        key: {"kernel": params["attn"][key]["kernel"][:, k0:k1].contiguous()}
        for key in ("k", "v")})
    return dict(params, attn=attn)


def _fresh(tree):
    return transformer.tree_map(
        lambda z: z.detach().clone().requires_grad_(True), tree)


def layer_times(mesh, dev) -> None:
    cfg = get_config(cs.MD_ARCH)
    gen = torch.Generator(device=dev).manual_seed(31)
    block = transformer.tree_map(
        lambda x: x.to(cfg.param_dtype),
        transformer.init_block(gen, cfg, "attn", dev))
    x = torch.randn((cs.MD_BATCH, cs.MD_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(cfg.dtype)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(cfg.dtype)
    pos = torch.arange(cs.MD_SEQ, dtype=torch.int32,
                       device=dev)[None].expand(cs.MD_BATCH, -1)
    xg = x.detach().clone().requires_grad_(True)
    for n in (1, 2, 4, 8):
        local, split = cs._md_rank_block(block, cfg, n, 0, mesh)
        k0, k1 = split.kv
        whole, pre_cut = _fresh(local), _fresh(_cut(local, k0, k1))
        no_kv = BlockSplit(split.attn, None, split.mlp)

        def time_it(params, s, cut):
            leaves = cs._leaves(params)

            def fwd_bwd():
                p = _cut(params, k0, k1) if cut else params
                y = transformer.apply_block(p, cfg, "attn", xg, pos,
                                            split=s)[0]
                return torch.autograd.grad(y, [xg] + leaves, dy)
            return cs.kernel_ms(fwd_bwd, iters=10, warmup=2)

        ways = {"A": (whole, split, False), "B": (pre_cut, no_kv, False),
                "C": (whole, no_kv, True)}
        res = {key: [] for key in ways}
        for key in "ABCCBA":
            res[key].append(time_it(*ways[key]))

        h = x.detach().clone().requires_grad_(True)
        w = block["attn"]["k"]["kernel"].detach().clone().requires_grad_(True)
        dk = torch.randn((cs.MD_BATCH, cs.MD_SEQ, (k1 - k0) * cfg.resolved_head_dim),
                         generator=gen, device=dev).to(cfg.dtype)

        def k_proj(view):
            part = w[:, k0:k1] if view else w[:, k0:k1].contiguous()
            out = h @ part.reshape(part.shape[0], -1)
            return torch.autograd.grad(out, [h, w], dk)

        view = cs.kernel_ms(lambda: k_proj(True), iters=10)
        copy = cs.kernel_ms(lambda: k_proj(False), iters=10)
        print(f"n={n} kv heads [{k0}, {k1}): layer fwd + bwd ms, A view "
              f"{res['A']}, B pre-cut {res['B']}, C cut inside {res['C']}; "
              f"k projection fwd + bwd on the view {view:.4f}, on a copy "
              f"{copy:.4f}", flush=True)


def main() -> int:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s; {cs._nvidia_smi()}",
          flush=True)
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group("nccl", init_method=f"file://{root}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            layer_times(mesh, dev)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device meshes (the JAX package's ``repro/launch/mesh.py``) as
``torch.distributed`` ``DeviceMesh``es over the launched world.

Functions, not module-level constants, so importing this module touches
no process group.  Both need ``torch.distributed`` initialized (the
entry points do it from ``torchrun``'s environment).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device) -> str:
    return "cuda" if device is None else torch.device(device).type


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """Single pod: (16, 16) = 256 ranks, axes (data, model).
    Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'production'} mesh "
            f"{shape} needs a world of {need} ranks, this one has {world} "
            f"(use --local for a mesh over the launched world)")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_local_mesh(model_axis: int = 1, device=None) -> DeviceMesh:
    """(world // model_axis, model_axis) over the launched world, axes
    (data, model); on ``cuda`` unless ``device`` says otherwise."""
    world = dist.get_world_size()
    if world % model_axis:
        raise ValueError(f"a world of {world} does not split into "
                         f"model_axis={model_axis}")
    return init_device_mesh(_device_type(device),
                            (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates; the cards this
# repository measures on report "NVIDIA H100 80GB HBM3, 700.00 W" to
# nvidia-smi), in place of the JAX package's TPU v5e constants.
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, tensor cores
HBM_BW = 3.35e12               # bytes/s, HBM3
NVLINK_BW = 450e9              # bytes/s, NVLink 4, one direction
HBM_PER_CHIP = 80e9            # bytes

"""Device mesh helper (counterpart of ``stereo_vo_tpu/parallel/mesh.py``).

A ``torch.distributed`` ``DeviceMesh`` over the ranks of the current world;
``mesh.get_group("lm")`` is the process group the landmark-sharded solver
reduces over (NCCL across cards, gloo on the CPU).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("lm",),
    device_type: str = "cuda",
) -> DeviceMesh:
    """Build a mesh over the first ``prod(shape)`` ranks of the world.

    Default: a 1-D ``("lm",)`` mesh over every rank, the landmark-sharding
    axis of the distributed bundle adjuster. ``shape=(dp, lm)`` with
    ``axis_names=("dp", "lm")`` gives data-parallel batches of sharded
    solves. Every rank of the world calls it (the sub-groups are created
    collectively), including ranks the mesh leaves out."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(initialize_multihost or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(shape)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, have {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))

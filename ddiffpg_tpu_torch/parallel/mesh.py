"""The device mesh of a data-parallel run."""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device: str = "cuda") -> DeviceMesh:
    """A one-dimensional `DeviceMesh` named `axis` over the ranks of the
    process group the caller already started (NCCL across cards, gloo on
    the CPU or for several ranks on one card), on that group itself: no
    other group is made (`init_device_mesh` would add an NCCL group beside
    a gloo one, which two ranks on one card cannot use). `n_devices`, when
    given, must be its world size: every rank holds a share."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: start a process group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"process group has {world} ranks")
    return DeviceMesh.from_group(dist.group.WORLD, device,
                                 mesh_dim_names=(axis,))

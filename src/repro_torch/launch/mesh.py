"""Meshes (the port of `repro.launch.mesh`).

Single pod  : (16, 16) over ("data", "model")  — 256 ranks, the MemPool
              cluster analogue (256 PEs).
Multi-pod   : (2, 16, 16) over ("pod", "data", "model") — 512 ranks.

The production and test shapes are plain descriptions (`MeshSpec`): the
planner reads only axis names and sizes, so they are planned with no
ranks at all. `make_device_mesh` makes a live DeviceMesh over an
initialised process group (one rank a device), which the sharded
train step runs on; it never starts a group of its own.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.addressing import MeshSpec


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def make_test_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """Scaled-down mesh for CI: 8 ranks, the same axis structure."""
    if multi_pod:
        return MeshSpec((2, 2, 2), ("pod", "data", "model"))
    return MeshSpec((2, 4), ("data", "model"))


def make_device_mesh(mesh: MeshSpec, device_type: str = "cuda"):
    """A DeviceMesh of `mesh`'s shape and axis names over the initialised
    default process group, whose world size must be the mesh's size. An
    uninitialised group raises: a launcher (`launch/train.py`, torchrun)
    starts it."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh: no process group is "
                           "initialised (torch.distributed."
                           "init_process_group first)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"make_device_mesh: mesh {mesh.sizes} holds "
                         f"{mesh.size} ranks, the group "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)

"""The dry run's mesh and route (the port's counterpart of
`repro.core.compat`).

`abstract_mesh(sizes, names)` is the port's abstract mesh: a fake
process group (`torch.testing._internal.distributed.fake_pg`, which
communicates nothing) of the mesh's size, started at one rank of this
process, and a DeviceMesh of the mesh's shape over it. The group is
destroyed on the way out. It refuses to start while any process group
is initialised, so that a dry run never rides on a real NCCL or gloo
world. `tracing_card()` (`device.tracing_card`) routes meta tensors
along the card's kernels for the dry run's trace.

Where each other function of the reference module went:

* `make_mesh` is `launch/mesh.make_device_mesh` (a DeviceMesh over the
  initialised group);
* `shard_map` and `set_mesh` do not apply: the port computes each
  rank's block explicitly (`cluster/cells.build_cell`), and no compiler
  is handed a mesh;
* `pallas_hints` / `pallas_compiler_params` do not apply: each Hopper
  kernel is written by hand, and nvcc's flags are in `kernels/build.py`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence

import torch.distributed as dist

from repro_torch.device import tracing_card

__all__ = ["abstract_mesh", "tracing_card"]


@contextlib.contextmanager
def abstract_mesh(sizes: Sequence[int], names: Sequence[str], *,
                  rank: int = 0) -> Iterator:
    """A DeviceMesh of `sizes` over `names` on a fake process group of
    prod(sizes) ranks, this process being rank `rank`; the group is
    destroyed when the block ends."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed import fake_pg

    if dist.is_initialized():
        raise RuntimeError("abstract_mesh: a process group is initialised; "
                           "a dry run does not start on a live world")
    world = math.prod(sizes)
    if not 0 <= rank < world:
        raise ValueError(f"abstract_mesh: rank {rank} outside a world of "
                         f"{world}")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield init_device_mesh("cpu", tuple(sizes),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()

"""Hardware constants and the machine hierarchy of the NVIDIA H100 SXM —
the port's counterpart of `repro.core.mesh` (whose numbers are a TPU
v5e's).

MemPool (paper Fig. 1)           This module (H100 SXM nodes)
---------------------------      -------------------------------------------
tile   : 4 cores + 16 banks,     card  : 132 SMs + 80 GB HBM3   (level 0,
         1-cycle local xbar               no collective)
group  : 16 tiles, 3-cycle       node  : 8 cards on NVLink 4    (level 1,
         local crossbar                   through NVSwitch, all to all)
cluster: 4 groups, 5-cycle       fleet : nodes on an InfiniBand (level 2,
         remote crossbars                 NDR fabric, a port a card)

The constants are the H100 SXM data sheet's; `launch/roofline.py`, the
tuning layer's cost model (`kernels/pipeline.score`), `chip_smoke.py`'s
bounds and `core/interconnect.CollectiveModel` read them from here, so
there is one copy. The levels' latencies are the α–β model's assumptions,
not data-sheet figures and not measurements. Meshes themselves (axis
names and sizes, the shardings a plan gives them) are
`core/addressing.py`'s and `launch/mesh.py`'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

SMS = 132                          # streaming multiprocessors
SMEM_PER_BLOCK = 227 * 1024        # shared memory a block may opt in to
L2_BYTES = 50 * 1024**2            # L2 cache
HBM_BYTES = 80 * 1000**3           # device memory (80 GB)
HBM_BW = 3.35e12                   # B/s
PEAK_FLOPS_BF16 = 989e12           # dense bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12           # dense TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12             # f32 on the CUDA cores

# the peak of each operand type a kernel's products run at
PEAKS = {"bf16": PEAK_FLOPS_BF16, "tf32": PEAK_FLOPS_TF32,
         "f32": PEAK_FLOPS_F32}

# NVLink 4 on an H100 SXM (data sheet): 18 links, 900 GB/s both ways
# together, so 450 GB/s a direction for the card and 25 GB/s a link.
NVLINK_LINKS = 18
NVLINK_BW = 450e9                  # B/s a direction, a card
NVLINK_BW_PER_LINK = NVLINK_BW / NVLINK_LINKS
NODE_GPUS = 8                      # cards an NVSwitch node holds (HGX H100)
# Between nodes: one 400 Gb/s InfiniBand NDR port a card (the data
# sheet's figure for the port, not a measurement): 50 GB/s a direction.
NETWORK_BW_PER_GPU = 400e9 / 8
# The α of each level: assumptions of the α–β model, of the order an
# HBM access, an NVLink hop through the switch and a network hop take.
HBM_LATENCY_S = 1e-7
NVLINK_LATENCY_S = 1e-6
NETWORK_LATENCY_S = 5e-6

# axes that cross nodes; every other axis stays inside a node's NVLink
OUTER_AXES = ("pod", "node")


@dataclasses.dataclass(frozen=True)
class Level:
    """One level of the machine hierarchy (tile / group / cluster
    analogue)."""
    name: str
    fanout: int          # number of children units at this level
    latency_s: float     # one-way latency to cross this level
    bw_bytes: float      # per-card bandwidth available at this level


@dataclasses.dataclass(frozen=True)
class Topology:
    """Hierarchical topology with per-level latency and bandwidth.

    `levels[0]` is the card itself (HBM); higher indices are
    progressively remote, the paper's tile < group < cluster ordering.
    An axis named in `OUTER_AXES` crosses the outermost level; every
    other axis crosses `levels[1]`."""
    levels: tuple[Level, ...]
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def n_chips(self) -> int:
        return math.prod(self.mesh_shape)

    def level(self, name: str) -> Level:
        for lvl in self.levels:
            if lvl.name == name:
                return lvl
        raise KeyError(name)

    def axis_size(self, axis: str) -> int:
        return self.mesh_shape[self.axis_names.index(axis)]

    def axis_level(self, axis: str) -> Level:
        """The level a collective over `axis` crosses."""
        if axis in OUTER_AXES:
            return self.levels[-1]
        return self.levels[1]

    def ranks_level(self, ranks: Sequence[int]) -> Level:
        """The level a collective over these global ranks crosses: the
        card's own for one rank, NVLink when they share a node (ranks
        r // NODE_GPUS equal: a mesh's ranks fill nodes in order), else
        the network."""
        nodes = {r // NODE_GPUS for r in ranks}
        if len(set(ranks)) < 2:
            return self.levels[0]
        return self.levels[1] if len(nodes) == 1 else self.levels[-1]

    def bisection_bw(self, axis: str) -> float:
        """Aggregate bandwidth across the bisection of one mesh axis (B/s).

        NVSwitch and the network's fat tree are switched, not a torus (the
        reference's v5e formula): a cut of the axis into halves is crossed
        by every card of one half at its level's per-card rate, for each
        of the other axes' rows."""
        n = self.axis_size(axis)
        other = self.n_chips // n
        return (n // 2) * other * self.axis_level(axis).bw_bytes

    def ring_allgather_time(self, axis: str, bytes_per_chip: float) -> float:
        """Ring all-gather of `bytes_per_chip` over one axis (α–β model)."""
        n = self.axis_size(axis)
        if n <= 1:
            return 0.0
        lvl = self.axis_level(axis)
        steps = n - 1
        return steps * (lvl.latency_s + bytes_per_chip / lvl.bw_bytes)


def h100_topology(mesh_shape: Sequence[int],
                  axis_names: Sequence[str]) -> Topology:
    """H100 SXM nodes: HBM, NVLink 4 inside a node of 8 cards, one NDR
    port a card between nodes. The network level's fanout is the number
    of nodes the mesh's outer axes span."""
    nodes = math.prod(s for s, a in zip(mesh_shape, axis_names)
                      if a in OUTER_AXES)
    levels = (
        Level("hbm", 1, HBM_LATENCY_S, HBM_BW),
        Level("nvlink", NODE_GPUS, NVLINK_LATENCY_S, NVLINK_BW),
        Level("network", nodes, NETWORK_LATENCY_S, NETWORK_BW_PER_GPU),
    )
    return Topology(levels=levels, mesh_shape=tuple(mesh_shape),
                    axis_names=tuple(axis_names))

"""Interconnect models — MemPool §3 (Fig. 4/5) and the collective cost model
(the port of `repro.core.interconnect`).

1. `TopologyModel` — a queueing-flavoured throughput/latency model of the
   paper's three candidate interconnects (Top_1, Top_4, Top_H), driven by
   injected load and p_local. It models MemPool's L1 banks, not the card:
   the serving groups' placement (`runtime/groups.MeshScheduler`) scores a
   group with it, and `examples/locality_pipeline_torch.py` prints it. Its
   arithmetic is the reference's, float for float.

2. `CollectiveModel` — α–β cost of ring collectives over the axes of a
   `core.mesh.Topology`. Each axis's α and β are the level it crosses
   (NVLink inside a node, the network between nodes on an H100 fleet),
   so the same model prices the reference's v5e mesh when it is given
   the reference's levels.
"""

from __future__ import annotations

import dataclasses

from . import mesh as hw

# ----------------------------------------------------------------------------
# 1. Paper topology model (Fig. 4 / Fig. 5)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopoSpec:
    name: str
    remote_ports: int       # outgoing remote request ports per tile
    base_latency: float     # cycles, uncongested remote round-trip
    local_latency: float    # cycles, within-tile access
    group_latency: float    # cycles, within-group (Top_H only)
    p_group: float          # fraction of remote traffic staying in-group
    saturation: float       # req/core/cycle at which the fabric saturates


TOP_1 = TopoSpec("Top_1", remote_ports=1, base_latency=5.0, local_latency=1.0,
                 group_latency=5.0, p_group=0.0, saturation=0.105)
TOP_4 = TopoSpec("Top_4", remote_ports=4, base_latency=5.0, local_latency=1.0,
                 group_latency=5.0, p_group=0.0, saturation=0.37)
TOP_H = TopoSpec("Top_H", remote_ports=4, base_latency=5.0, local_latency=1.0,
                 group_latency=3.0, p_group=0.25, saturation=0.40)


class TopologyModel:
    """M/D/1-flavoured latency & accepted-throughput vs injected load.

    Requests are uniformly distributed over banks (paper §3.3.1): with 64
    tiles, 1/64 of requests are local by chance; `p_local` adds the hybrid
    addressing scheme's sequential-region hits on top (paper §3.3.2).
    """

    def __init__(self, spec: TopoSpec, n_tiles: int = 64):
        self.spec = spec
        self.n_tiles = n_tiles

    def split(self, p_local: float) -> tuple[float, float, float]:
        chance_local = 1.0 / self.n_tiles
        p_loc = p_local + (1 - p_local) * chance_local
        p_rem = 1.0 - p_loc
        p_grp = p_rem * self.spec.p_group
        p_far = p_rem - p_grp
        return p_loc, p_grp, p_far

    def accepted_load(self, injected: float, p_local: float = 0.0) -> float:
        """Accepted throughput (req/core/cycle) given injected load: the
        remote share is cut at the fabric's saturation."""
        injected = min(injected, 1.0)     # a core issues <= 1 req/cycle
        p_loc, p_grp, p_far = self.split(p_local)
        remote = injected * (p_grp + p_far)
        accepted_remote = min(remote, self.spec.saturation)
        scale = accepted_remote / remote if remote > 1e-12 else 1.0
        return injected * p_loc + injected * (p_grp + p_far) * scale

    def avg_latency(self, injected: float, p_local: float = 0.0) -> float:
        """Average round-trip latency (cycles) with M/D/1 congestion blow-up."""
        p_loc, p_grp, p_far = self.split(p_local)
        rho = min(injected * (p_grp + p_far) / self.spec.saturation, 0.999)
        # M/D/1 waiting time: rho / (2 (1 - rho)) service units
        queue = rho / (2.0 * (1.0 - rho)) * self.spec.base_latency
        lat = (p_loc * self.spec.local_latency
               + p_grp * (self.spec.group_latency + queue)
               + p_far * (self.spec.base_latency + queue))
        return lat


# ----------------------------------------------------------------------------
# 2. Collective cost model (α–β on the hierarchical mesh)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    seconds: float
    bytes_on_wire: float


class CollectiveModel:
    """Ring collectives over one axis of `topo`: α a step and β from the
    level the axis crosses (`Topology.axis_level`). The default topology
    is one H100 node: 8 cards on NVLink along a "data" axis."""

    def __init__(self, topo: hw.Topology | None = None):
        self.topo = (topo if topo is not None
                     else hw.h100_topology((hw.NODE_GPUS,), ("data",)))

    def _axis_bw_lat(self, axis: str) -> tuple[float, float]:
        lvl = self.topo.axis_level(axis)
        return lvl.bw_bytes, lvl.latency_s

    def all_gather(self, shard_bytes: float, axis: str) -> CollectiveCost:
        n = self.topo.axis_size(axis)
        if n <= 1:
            return CollectiveCost(0.0, 0.0)
        bw, lat = self._axis_bw_lat(axis)
        steps = n - 1
        sec = steps * lat + (n - 1) / n * (shard_bytes * n) / bw
        return CollectiveCost(sec, shard_bytes * (n - 1))

    def reduce_scatter(self, full_bytes: float, axis: str) -> CollectiveCost:
        n = self.topo.axis_size(axis)
        if n <= 1:
            return CollectiveCost(0.0, 0.0)
        bw, lat = self._axis_bw_lat(axis)
        steps = n - 1
        sec = steps * lat + (n - 1) / n * full_bytes / bw
        return CollectiveCost(sec, full_bytes * (n - 1) / n)

    def all_reduce(self, full_bytes: float, axis: str) -> CollectiveCost:
        rs = self.reduce_scatter(full_bytes, axis)
        ag = self.all_gather(full_bytes / max(self.topo.axis_size(axis), 1),
                             axis)
        return CollectiveCost(rs.seconds + ag.seconds,
                              rs.bytes_on_wire + ag.bytes_on_wire)

    def all_to_all(self, full_bytes: float, axis: str) -> CollectiveCost:
        n = self.topo.axis_size(axis)
        if n <= 1:
            return CollectiveCost(0.0, 0.0)
        bw, lat = self._axis_bw_lat(axis)
        sec = (n - 1) * lat / n + full_bytes * (n - 1) / n / bw
        return CollectiveCost(sec, full_bytes * (n - 1) / n)

    def collective_term_seconds(self, bytes_by_kind: dict[str, float]
                                ) -> float:
        """Roofline collective term: a card's wire bytes over its bandwidth
        at the first interconnect level (NVLink's 450 GB/s a direction on
        an H100; the reference divides by three v5e ICI links)."""
        total = sum(bytes_by_kind.values())
        return total / self.topo.levels[1].bw_bytes

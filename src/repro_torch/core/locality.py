"""Locality of a traced cell — the p_local measurement (the port of
`repro.core.locality`).

MemPool evaluates its hybrid addressing by the share of requests the
local tile serves (Fig. 5). Here: of all the bytes a step touches, how
many cross the interconnect as collectives? The reference reads its
collectives from XLA's compiled text; the port counts them where they
are issued (`core/collectives.py`'s `ledger()`: each call's kind, its
result's bytes and its group), and prices each with the reference's
algebra (`_op_bytes`, float for float):

    all-gather      result = operand * g      -> operand = result / g
    all-reduce      result = operand          -> operand = result
    reduce-scatter  result = operand / g      -> operand = result * g
    all-to-all      result = operand          -> operand = result

`operand_bytes` is the sum of operand sizes; `wire_bytes` the ring
algorithm's bytes a rank puts on the wire, which p_local reads.
`collective_seconds` puts each call's operand bytes over the bandwidth
of the level its group spans (`core/mesh.Topology.ranks_level`).

`extract_memory` / `extract_costs` read a trace's tracker
(`core/op_cost.tracked`) as the reference's read XLA's compiled
analyses; `peak_device_bytes` is the reference's formula.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class CollectiveStats:
    count: int = 0
    operand_bytes: float = 0.0   # the sum of operand sizes
    wire_bytes: float = 0.0      # ring-algorithm bytes a rank sends


@dataclasses.dataclass
class LocalityReport:
    by_kind: dict[str, CollectiveStats]

    @property
    def operand_bytes(self) -> float:
        return sum(s.operand_bytes for s in self.by_kind.values())

    @property
    def wire_bytes(self) -> float:
        return sum(s.wire_bytes for s in self.by_kind.values())

    @property
    def count(self) -> int:
        return sum(s.count for s in self.by_kind.values())

    def p_local(self, total_bytes_accessed: float) -> float:
        """Share of touched bytes served without crossing the
        interconnect."""
        if total_bytes_accessed <= 0:
            return 1.0
        return max(0.0, 1.0 - self.wire_bytes / total_bytes_accessed)

    def as_dict(self) -> dict:
        return {k: dataclasses.asdict(v) for k, v in sorted(self.by_kind.items())
                } | {"total_operand_bytes": self.operand_bytes,
                     "total_wire_bytes": self.wire_bytes,
                     "total_count": self.count}


def _op_bytes(kind: str, result_bytes: float, g: int) -> tuple[float, float]:
    """(operand_bytes, wire_bytes a rank) from result bytes and group
    size."""
    g = max(g, 1)
    if kind == "all-gather":
        operand = result_bytes / g
        wire = operand * (g - 1)
    elif kind == "all-reduce":
        operand = result_bytes
        wire = operand * 2.0 * (g - 1) / g
    elif kind == "reduce-scatter":
        operand = result_bytes * g
        wire = result_bytes * (g - 1)
    elif kind in ("all-to-all", "ragged-all-to-all"):
        operand = result_bytes
        wire = operand * (g - 1) / g
    else:  # collective-permute, collective-broadcast
        operand = result_bytes
        wire = operand
    return operand, wire


def report(calls) -> LocalityReport:
    """The `LocalityReport` of counted collective calls
    (`collectives.Call`s)."""
    by_kind: dict[str, CollectiveStats] = defaultdict(CollectiveStats)
    for c in calls:
        operand, wire = _op_bytes(c.kind, float(c.result_bytes),
                                  len(c.ranks))
        st = by_kind[c.kind]
        st.count += 1
        st.operand_bytes += operand
        st.wire_bytes += wire
    return LocalityReport(by_kind=dict(by_kind))


def collective_seconds(calls, topology) -> float:
    """Each call's operand bytes over the bandwidth of the level its
    group spans; a one-rank group moves nothing."""
    total = 0.0
    for c in calls:
        if len(c.ranks) < 2:
            continue
        operand, _ = _op_bytes(c.kind, float(c.result_bytes), len(c.ranks))
        total += operand / topology.ranks_level(c.ranks).bw_bytes
    return total


# ----------------------------------------------------------------------------
# the trace's memory and built-in cost (the reference's compiled analyses)
# ----------------------------------------------------------------------------

def extract_costs(tracker) -> dict[str, float]:
    """The built-in count of the trace: `FlopCounterMode`'s flops, which
    do not see the hand-written kernels (as XLA's do not see loops)."""
    return {"flops": float(tracker.ops.products)}


def extract_memory(tracker) -> dict[str, float]:
    """The trace's memory, under the names of XLA's memory analysis: the
    arguments' bytes (this rank's blocks), the result's, the live peak
    above the arguments and the result's new storages (temp), and the
    donated arguments' bytes the cell updates in place (alias)."""
    fresh = tracker.output_bytes - tracker.alias_bytes - \
        tracker.output_argument_bytes
    temp = max(tracker.peak_bytes - tracker.argument_bytes - fresh, 0)
    return {"argument_size_in_bytes": float(tracker.argument_bytes),
            "output_size_in_bytes": float(tracker.output_bytes),
            "temp_size_in_bytes": float(temp),
            "alias_size_in_bytes": float(tracker.alias_bytes)}


def peak_device_bytes(mem: dict[str, float]) -> float:
    """Upper-bound live bytes per device during execution."""
    return (mem.get("argument_size_in_bytes", 0.0)
            + mem.get("output_size_in_bytes", 0.0)
            + mem.get("temp_size_in_bytes", 0.0)
            - mem.get("alias_size_in_bytes", 0.0))

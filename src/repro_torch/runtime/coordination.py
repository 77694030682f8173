"""Host-side coordination for elastic scale and fault events (the port of
`repro.runtime.coordination`).

The fleet analogue of MemPool's wake-up triggers and control registers: a
tiny event bus the launcher uses to re-plan the mesh when membership
changes. On a real fleet it fronts the cluster's coordinator (a
scheduler's membership signals); here it is an in-process implementation
with the reference's semantics, so the elastic logic is testable.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable


@dataclasses.dataclass
class MemberEvent:
    kind: str          # "join" | "leave" | "preempt-notice"
    host: str
    time: float


class Coordinator:
    def __init__(self, n_hosts: int):
        self.n_hosts = n_hosts
        self.events: list[MemberEvent] = []
        self.listeners: list[Callable[[MemberEvent], None]] = []

    def emit(self, kind: str, host: str):
        ev = MemberEvent(kind, host, time.time())
        self.events.append(ev)
        if kind == "leave":
            self.n_hosts -= 1
        elif kind == "join":
            self.n_hosts += 1
        for fn in self.listeners:
            fn(ev)

    def subscribe(self, fn: Callable[[MemberEvent], None]):
        self.listeners.append(fn)


def replan_mesh_shape(n_chips: int, *, model_parallel: int = 16,
                      pods: int = 1) -> tuple[int, ...]:
    """Choose a mesh shape for the surviving card count (elastic restart).

    Keeps the model axis fixed (weight layout unchanged -> cheapest
    restore) and shrinks the data axis to the largest power-of-two degree
    the survivors hold. Mirrors MemPool's fixed tile structure with a
    variable number of active groups.
    """
    per_pod = n_chips // pods
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError(f"{n_chips} chips cannot host model={model_parallel}")
    data = 2 ** int(math.log2(data))
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)

"""Fault injection + wedge detection for the serving session (the port of
`repro.runtime.faults`, plain Python: the same kinds, firing rules and
`summary()`).

MemPool's robustness claim is architectural: PEs execute independently,
so one stalled core never wedges the cluster and a dead core only costs
its own lanes. Nothing in a software system earns that property without
being exercised — this module is the harness that exercises it. A
`FaultPlan` scripts failures against a `ServeSession` at exact chunk
indices, so chaos runs are reproducible and CI can assert the recovery
contract: every surviving request's tokens are bit-identical to a
fault-free run.

Fault kinds (all fire exactly once, at their scripted chunk):

* ``kill_slot``  — the slot's device row is declared dead at harvest of
  chunk N. Recovery: quarantine the slot (the pool degrades, never
  crashes), discard the request's partial tokens, requeue it with
  bounded retries + exponential backoff.
* ``corrupt_nan`` — the slot's float cache rows are overwritten with NaN
  before chunk N dispatches. Detection is the session's NaN sentinel
  scan on harvest; recovery requeues the request and recycles (zeroes)
  the slot — transient corruption does not cost pool capacity.
* ``wedge``      — chunk N's device wait never completes (the injected
  wait never polls the chunk's CUDA event). Detection is the session
  watchdog (``watchdog_s`` / ``poll(timeout_s=...)``), which raises
  `SessionWedged` with the StallClock ledger attached; recovery is
  `session.recover_wedged()` — rebuild the pool, requeue everything
  that was running.
* ``refill_error`` — the refill program raises at chunk boundary N. The
  session un-admits the round and retries at the next boundary.
* ``page_alloc_fail`` — every paged-KV page allocation at chunk boundary
  N reports `PoolExhausted` (runtime/kvpool.py). Recovery is the typed
  shed/requeue path: the affected admissions are un-admitted and requeued
  at the front of their class — no crash, no token loss — and the
  session's `stats()["kv"]["pool_exhausted"]` counter records the event.
* ``bit_flip``   — a published KV page's device content is silently
  perturbed (finite values, not NaN) before chunk N dispatches. The NaN
  sentinel scan cannot see it by design; detection is the per-page
  content checksum (stamped at `PagedKV.publish`), verified before the
  page is shared via the PrefixCache and by the background scrub.
  Recovery quarantines the page, drops the poisoned prefix chain, and
  repairs by recompute (the next requester re-prefills).
* ``crash``      — the process dies at the END of chunk N's poll, after
  the journal commit (`crash_hook`; the default raises `SessionCrashed`,
  the chaos harness SIGKILLs itself for a true ``kill -9``). Recovery is
  out-of-process: restart + `restore()` replays the journal/snapshot.

The plan is injected per-session (``program.open(faults=plan)`` or the
``faults=`` constructor argument) and threaded through the session as
query hooks — the session stays fault-free code when no plan is attached.

Thread safety: a plan may be consulted from more than one thread (the
reference's watchdog waits on a thread of its own), so all mutation of
`_consumed`/`fired` happens under one internal lock.
"""

from __future__ import annotations

import dataclasses
import threading

KINDS = ("kill_slot", "corrupt_nan", "wedge", "refill_error",
         "page_alloc_fail", "bit_flip", "crash")


class InjectedFault(RuntimeError):
    """An error raised by the fault harness itself (e.g. refill_error)."""


class SessionWedged(RuntimeError):
    """The device never completed a chunk within the watchdog timeout.

    Carries the session's StallClock ledger at the moment of detection
    (`stall`) and the wedged chunk index (`chunk`), so the operator sees
    how long the device sat silent and where. Raised by
    `ServeSession.poll/stream/drain` when `timeout_s` (or the session's
    `watchdog_s`) elapses; `session.recover_wedged()` rebuilds the pool.
    """

    def __init__(self, chunk: int, timeout_s: float, stall: dict):
        super().__init__(
            f"device did not complete chunk {chunk} within {timeout_s:.3f}s "
            f"(host_syncs={stall.get('host_syncs')}, "
            f"device_wait_s={stall.get('device_wait_s', 0.0):.3f})")
        self.chunk = chunk
        self.timeout_s = timeout_s
        self.stall = stall


class SessionCrashed(RuntimeError):
    """The scripted ``crash`` fault fired: the process is declared dead
    at the end of this chunk's poll (after the journal commit). In-
    process harnesses catch this and re-open the session with
    ``resume=True``; the chaos subprocess harness SIGKILLs itself
    instead so the restart is a true ``kill -9`` recovery."""

    def __init__(self, chunk: int):
        super().__init__(f"injected process crash at end of chunk {chunk}")
        self.chunk = chunk


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted failure: `kind` at chunk `at_chunk` (slot-targeted
    kinds carry `slot`; ``bit_flip`` may carry a target `page`)."""

    kind: str
    at_chunk: int
    slot: int | None = None
    page: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.at_chunk < 0:
            raise ValueError(f"at_chunk must be >= 0, got {self.at_chunk}")
        needs_slot = self.kind in ("kill_slot", "corrupt_nan")
        if needs_slot and self.slot is None:
            raise ValueError(f"{self.kind} needs a target slot")
        if not needs_slot and self.slot is not None:
            raise ValueError(f"{self.kind} does not take a slot")
        if self.page is not None and self.kind != "bit_flip":
            raise ValueError(f"{self.kind} does not take a page")


class FaultPlan:
    """A reproducible script of failures, queried by the session.

    Build fluently::

        plan = (FaultPlan()
                .kill_slot(at_chunk=2, slot=0)
                .corrupt_nan(at_chunk=4, slot=1)
                .wedge(at_chunk=6)
                .refill_error(at_chunk=3))

    Each fault fires exactly once; `fired` records what actually fired
    (kind, chunk, slot) in firing order, and `summary()` aggregates it
    for the `# chaos:` report line.
    """

    def __init__(self, faults: "list[Fault] | None" = None):
        self.faults: list[Fault] = list(faults or [])
        self.fired: list[tuple[str, int, int | None]] = []
        self._consumed: set[int] = set()
        # a plan may be consumed and inspected from several threads
        self._lock = threading.Lock()

    # -- construction ----------------------------------------------------
    def add(self, kind: str, at_chunk: int, slot: int | None = None,
            page: int | None = None):
        self.faults.append(Fault(kind, at_chunk, slot, page))
        return self

    def kill_slot(self, at_chunk: int, slot: int) -> "FaultPlan":
        return self.add("kill_slot", at_chunk, slot)

    def corrupt_nan(self, at_chunk: int, slot: int) -> "FaultPlan":
        return self.add("corrupt_nan", at_chunk, slot)

    def wedge(self, at_chunk: int) -> "FaultPlan":
        return self.add("wedge", at_chunk)

    def refill_error(self, at_chunk: int) -> "FaultPlan":
        return self.add("refill_error", at_chunk)

    def page_alloc_fail(self, at_chunk: int) -> "FaultPlan":
        return self.add("page_alloc_fail", at_chunk)

    def bit_flip(self, at_chunk: int, page: int | None = None) -> "FaultPlan":
        """Silently perturb a published KV page's content before this
        chunk (page=None targets the first stamped page at fire time)."""
        return self.add("bit_flip", at_chunk, page=page)

    def crash(self, at_chunk: int) -> "FaultPlan":
        """Kill the process at the end of this chunk's poll, after the
        journal commit."""
        return self.add("crash", at_chunk)

    # -- the session's queries (each consumes the fault it matches) ------
    def _take(self, kind: str, chunk: int) -> list[Fault]:
        out = []
        with self._lock:
            for i, f in enumerate(self.faults):
                if (i in self._consumed or f.kind != kind
                        or f.at_chunk != chunk):
                    continue
                self._consumed.add(i)
                self.fired.append((f.kind, chunk, f.slot))
                out.append(f)
        return out

    def kills(self, chunk: int) -> list[int]:
        """Slots declared dead at harvest of this chunk."""
        return [f.slot for f in self._take("kill_slot", chunk)]

    def corrupts(self, chunk: int) -> list[int]:
        """Slots whose cache rows go NaN before this chunk dispatches."""
        return [f.slot for f in self._take("corrupt_nan", chunk)]

    def wedged(self, chunk: int) -> bool:
        """True when this chunk's device wait must never complete."""
        return bool(self._take("wedge", chunk))

    def page_alloc_failed(self, boundary: int) -> bool:
        """True when page allocation at this chunk boundary is scripted
        to report `PoolExhausted` (paged-KV sessions only)."""
        return bool(self._take("page_alloc_fail", boundary))

    def check_refill(self, boundary: int) -> None:
        """Raises `InjectedFault` when the refill at this chunk boundary
        is scripted to fail."""
        if self._take("refill_error", boundary):
            raise InjectedFault(f"injected refill failure at chunk "
                                f"boundary {boundary}")

    def bit_flips(self, chunk: int) -> "list[int | None]":
        """Target pages to silently corrupt before this chunk dispatches
        (None = let the session pick the first stamped page)."""
        return [f.page for f in self._take("bit_flip", chunk)]

    def crashed(self, chunk: int) -> bool:
        """True when the process is scripted to die at the end of this
        chunk's poll."""
        return bool(self._take("crash", chunk))

    # -- introspection ---------------------------------------------------
    @property
    def has_wedge(self) -> bool:
        return any(f.kind == "wedge" for f in self.faults)

    @property
    def pending_wedge(self) -> bool:
        """A wedge is scripted and has not fired yet (the session checks
        this before dispatching: a wedge with no watchdog would block the
        session forever, which is a harness misconfiguration)."""
        with self._lock:
            return any(f.kind == "wedge" and i not in self._consumed
                       for i, f in enumerate(self.faults))

    @property
    def has_corruption(self) -> bool:
        return any(f.kind == "corrupt_nan" for f in self.faults)

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return len(self._consumed) == len(self.faults)

    def summary(self) -> dict:
        """{kind: fired count} plus planned totals, for the chaos line."""
        fired: dict[str, int] = {k: 0 for k in KINDS}
        with self._lock:
            n_fired = len(self.fired)
            for kind, _, _ in self.fired:
                fired[kind] += 1
        return {"planned": len(self.faults), "fired": n_fired,
                "by_kind": fired}

    def __repr__(self) -> str:
        return (f"FaultPlan({len(self.faults)} faults, "
                f"{len(self.fired)} fired)")

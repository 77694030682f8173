"""Request-level slot scheduler for the continuous-batching serve session
(the port of `repro.runtime.scheduler`, host-side Python and numpy).

A fixed pool of decode slots (the batch rows of the session cell) that
must never sit idle while work is queued: per-class bounded request
queues plus a slot table with pluggable admission order. The device-side
half (per-slot refill, masked stepping, slot snapshot/restore) lives in
`runtime/engine.py`.

Priority classes (the SLO layer):

* every request carries a class — ``latency`` (interactive, jumps the
  queue), ``throughput`` (bulk), or ``best_effort`` (sheddable) — and an
  optional ``deadline_s`` used for SLO accounting;
* admission orders by *effective* priority: class rank minus an
  anti-starvation aging boost (one rank per ``aging_rounds`` admission
  rounds waited), so no class starves;
* overload shedding: when the total queue depth crosses
  ``shed_watermark``, the newest queued *best-effort* requests are failed
  with reason ``"shed"`` until the depth is back at the watermark.
  Latency and throughput work is never shed — they get per-class
  `QueueFull` backpressure instead.

Invariants: a slot holds at most one running request; a request is
admitted only from a queue, at most once per queue residence
(preemption legitimately requeues and re-admits); same-class FIFO
admission keeps submit order ("longest_prefix" reorders by prompt length,
or by the paged pool's measured prefix reuse, within a rank); shedding
only fails best-effort requests; a quarantined slot is never assigned
again. `serialize_request` keeps the reference's keys, so a session
snapshot of either package holds requests the other can read.
`SlotScheduler.load_view` is what the serving groups' placement
(`runtime/groups.py`) reads of a pool.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Iterator

import numpy as np

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
FAILED = "failed"

ADMISSION_POLICIES = ("fifo", "longest_prefix")

CLASSES = ("latency", "throughput", "best_effort")
CLASS_RANK = {k: i for i, k in enumerate(CLASSES)}

# typed failure reasons carried by RequestFailed
REASON_CANCELLED = "cancelled"
REASON_SHED = "shed"
REASON_RETRIES = "retries_exhausted"
REASON_POOL = "pool_exhausted"      # paged KV: request can never fit


class QueueFull(RuntimeError):
    """The session's bounded request queue is at capacity (backpressure)."""


class RequestFailed(RuntimeError):
    """`result()` on a request that did not complete: carries the typed
    `reason` ("cancelled" | "shed" | "retries_exhausted") and whatever
    tokens were emitted before the failure (`partial_tokens`)."""

    def __init__(self, rid: int, reason: str, partial_tokens=None):
        super().__init__(f"request {rid} failed: {reason}")
        self.rid = rid
        self.reason = reason
        self.partial_tokens = (np.asarray([], np.int32)
                               if partial_tokens is None
                               else np.asarray(partial_tokens, np.int32))


@dataclasses.dataclass
class Request:
    """One decode request moving through the slot pool."""

    rid: int
    prompt: np.ndarray                      # (P,) int32, P >= 1
    max_new: int
    klass: str = "latency"
    deadline_s: float | None = None
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    state: str = QUEUED
    slot: int | None = None
    tokens: list = dataclasses.field(default_factory=list)
    started_at: float | None = None
    first_token_at: float | None = None
    finished_at: float | None = None
    hit_eos: bool = False
    fail_reason: str | None = None
    wait_rounds: int = 0                    # admission rounds spent queued
    retries: int = 0                        # fault-recovery restarts
    preemptions: int = 0                    # times checkpointed + requeued
    not_before: float = 0.0                 # retry backoff gate (perf_counter)
    snapshot: Any = None                    # preempted slot state (resume)
    prefix_pages_expected: int = 0          # measured page overlap at admit
    suppress_until: int = 0                 # exactly-once: tokens already
    #                                         journal-committed before a
    #                                         crash are regenerated but not
    #                                         re-delivered

    @property
    def emitted(self) -> int:
        return len(self.tokens)

    @property
    def rank(self) -> int:
        return CLASS_RANK[self.klass]

    def effective_rank(self, aging_rounds: int) -> int:
        """Class rank minus the anti-starvation aging boost."""
        return self.rank - self.wait_rounds // aging_rounds


class RequestHandle:
    """The caller's view of a submitted request (returned by `submit`)."""

    def __init__(self, req: Request):
        self._req = req

    @property
    def id(self) -> int:
        return self._req.rid

    @property
    def state(self) -> str:
        return self._req.state

    @property
    def klass(self) -> str:
        return self._req.klass

    @property
    def deadline_s(self) -> float | None:
        return self._req.deadline_s

    @property
    def done(self) -> bool:
        return self._req.state in (DONE, CANCELLED, FAILED)

    @property
    def ok(self) -> bool:
        return self._req.state == DONE

    @property
    def cancelled(self) -> bool:
        return self._req.state == CANCELLED

    @property
    def failed(self) -> bool:
        return self._req.state == FAILED

    @property
    def fail_reason(self) -> str | None:
        r = self._req
        return (REASON_CANCELLED if r.state == CANCELLED
                else r.fail_reason if r.state == FAILED else None)

    @property
    def tokens(self) -> np.ndarray:
        """Tokens emitted so far (includes EOS when the request hit it)."""
        return np.asarray(self._req.tokens, np.int32)

    @property
    def hit_eos(self) -> bool:
        return self._req.hit_eos

    def result(self) -> np.ndarray:
        """Completed tokens. Raises `RequestFailed` (typed reason, partial
        tokens attached) for a cancelled/shed/retries-exhausted request —
        a failure is never indistinguishable from success."""
        if not self.done:
            raise RuntimeError(f"request {self.id} is still {self.state}; "
                               f"drain() or poll() the session first")
        reason = self.fail_reason
        if reason is not None:
            raise RequestFailed(self.id, reason, self._req.tokens)
        return self.tokens

    @property
    def ttft_s(self) -> float | None:
        r = self._req
        if r.first_token_at is None:
            return None
        return r.first_token_at - r.submitted_at

    @property
    def latency_s(self) -> float | None:
        r = self._req
        if r.finished_at is None:
            return None
        return r.finished_at - r.submitted_at

    @property
    def missed_deadline(self) -> bool:
        r = self._req
        return (r.deadline_s is not None and r.finished_at is not None
                and (r.finished_at - r.submitted_at) > r.deadline_s)

    def __repr__(self) -> str:
        return (f"RequestHandle(id={self.id}, state={self.state}, "
                f"klass={self.klass}, emitted={self._req.emitted})")


class SlotScheduler:
    """Per-class bounded request queues + slot table with class-aware,
    aging-boosted admission.

    Pure host-side bookkeeping: it never touches device buffers, so the
    policy is unit-testable independent of the compiled session cell.

    `max_queue` bounds each class queue (QueueFull past it);
    `shed_watermark` bounds the *total* queue depth by failing the newest
    best-effort requests (reason "shed"); `aging_rounds` is the
    anti-starvation knob — every `aging_rounds` admission rounds a queued
    request waits, its effective priority rises one class rank.
    """

    def __init__(self, n_slots: int, *, max_queue: int | None = None,
                 policy: str = "fifo", shed_watermark: int | None = None,
                 aging_rounds: int = 8, prefix_score=None,
                 page_size: int | None = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"expected one of {ADMISSION_POLICIES}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if shed_watermark is not None and shed_watermark < 1:
            raise ValueError(f"shed_watermark must be >= 1, "
                             f"got {shed_watermark}")
        if aging_rounds < 1:
            raise ValueError(f"aging_rounds must be >= 1, got {aging_rounds}")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.policy = policy
        self.shed_watermark = shed_watermark
        self.aging_rounds = aging_rounds
        # paged-KV upgrade of "longest_prefix": a callable
        # `prompt -> reusable prefix tokens` (PagedKV.match_len) turns the
        # prompt-length heuristic into actual page-level reuse scoring;
        # `page_size` converts the score to pages for the admit decision's
        # `prefix_pages_expected` (correlated with kv prefix hits in stats)
        self.prefix_score = prefix_score
        self.page_size = page_size
        self._queues: dict[str, deque[Request]] = {k: deque() for k in CLASSES}
        self._slots: list[Request | None] = [None] * n_slots
        self._quarantined: set[int] = set()
        self._next_rid = 0
        # rids in admission order — bounded: a session admits without limit
        self.admitted_order: deque[int] = deque(maxlen=4096)
        self.queue_peak = 0
        self.shed_count: dict[str, int] = {k: 0 for k in CLASSES}
        # requests shed since the session last drained them (pop_shed):
        # shedding happens inside submit(), so the session discovers the
        # victims here rather than by scanning its handle table
        self._shed_log: list[Request] = []

    # -- queue -----------------------------------------------------------
    def submit(self, prompt, max_new: int, *, klass: str = "latency",
               deadline_s: float | None = None) -> Request:
        if klass not in CLASSES:
            raise ValueError(f"unknown class {klass!r}; "
                             f"expected one of {CLASSES}")
        q = self._queues[klass]
        if self.max_queue is not None and len(q) >= self.max_queue:
            raise QueueFull(f"the {klass} queue is at capacity "
                            f"({self.max_queue}); drain or poll first")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      klass=klass, deadline_s=deadline_s)
        self._next_rid += 1
        q.append(req)
        self.queue_peak = max(self.queue_peak, self.queued)
        self.shed_overflow()
        return req

    def shed_overflow(self) -> list[Request]:
        """Overload protection: while the total queue depth exceeds the
        watermark, fail the newest queued best-effort requests with reason
        "shed". Latency/throughput work is never shed. Returns the shed
        requests (so the session can surface events)."""
        shed: list[Request] = []
        if self.shed_watermark is None:
            return shed
        be = self._queues["best_effort"]
        while self.queued > self.shed_watermark and be:
            req = be[-1]                       # newest best-effort first
            self.fail(req, REASON_SHED)        # fail() dequeues it
            shed.append(req)
        self._shed_log.extend(shed)
        return shed

    def pop_shed(self) -> list[Request]:
        """Requests shed since the last call (the session's event/stats hook)."""
        out, self._shed_log = self._shed_log, []
        return out

    def fail(self, req: Request, reason: str) -> None:
        """Terminal failure (shed / retries exhausted). Queued requests are
        dequeued; the caller releases the slot of a running one."""
        if req.state == QUEUED:
            self._queues[req.klass].remove(req)
        req.state = FAILED
        req.fail_reason = reason
        req.finished_at = time.perf_counter()
        self.shed_count[req.klass] += (reason == REASON_SHED)

    def cancel(self, req: Request) -> bool:
        """Queued -> removed now; running -> marked (the session frees the
        slot at the next chunk boundary). Returns False if already over."""
        if req.state == QUEUED:
            self._queues[req.klass].remove(req)
            req.state = CANCELLED
            req.finished_at = time.perf_counter()
            return True
        if req.state == RUNNING:
            req.state = CANCELLED
            req.finished_at = time.perf_counter()
            return True
        return False

    def requeue(self, req: Request, *, front: bool = True,
                backoff_s: float = 0.0) -> None:
        """Put a released (preempted or fault-recovered) request back in
        its class queue — at the front by default, so a preempted request
        resumes as soon as its class gets a slot. `backoff_s` gates
        re-admission (fault retries back off; preemption resumes use 0)."""
        if req.slot is not None:
            raise RuntimeError("requeue before release")
        req.state = QUEUED
        req.not_before = (time.perf_counter() + backoff_s if backoff_s > 0
                          else 0.0)
        q = self._queues[req.klass]
        if front:
            q.appendleft(req)
        else:
            q.append(req)
        self.queue_peak = max(self.queue_peak, self.queued)

    # -- slot table ------------------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slots)
                if r is None and i not in self._quarantined]

    def quarantine(self, slot: int) -> None:
        """Permanently retire a slot (dead device row): it is never
        admitted into again — the pool degrades instead of crashing."""
        if self._slots[slot] is not None:
            raise RuntimeError(f"quarantine of an occupied slot {slot}")
        self._quarantined.add(slot)

    @property
    def quarantined(self) -> list[int]:
        return sorted(self._quarantined)

    @property
    def usable_slots(self) -> int:
        return self.n_slots - len(self._quarantined)

    def _admission_key(self, req: Request):
        rank = req.effective_rank(self.aging_rounds)
        if self.policy == "longest_prefix":
            if self.prefix_score is not None:
                # page-level reuse scoring: requests whose prompt prefix
                # is already resident in the shared KV pool go first —
                # they skip that much prefill, so admitting them early
                # frees their slot (and pages) soonest. Uncovered prompt
                # length breaks ties: the longest *remaining* prefill
                # starts earliest, preserving the heuristic's overlap
                # rationale for the part that still has to run.
                reused = int(self.prefix_score(req.prompt))
                if self.page_size:
                    # surfaced on the admit decision: the measured full-
                    # page overlap this request is expected to map
                    req.prefix_pages_expected = reused // self.page_size
                return (rank, -reused, -(req.prompt.size - reused),
                        req.rid)
            # longest prompt first within a rank: long prefills start
            # earliest so their extra slot-steps overlap short turnover
            return (rank, -req.prompt.size, req.rid)
        return (rank, req.rid)

    def admit(self, now: float | None = None) -> list[tuple[int, Request]]:
        """Assign queued requests to free slots: effective-priority order
        (class rank minus aging boost), FIFO within a rank. Requests whose
        retry backoff gate (`not_before`) is still in the future are
        skipped this round. Returns [(slot, request)], already RUNNING."""
        free = self.free_slots()
        if not self.queued:
            return []
        now = time.perf_counter() if now is None else now
        for q in self._queues.values():        # aging: everyone waits a round
            for req in q:
                req.wait_rounds += 1
        if not free:
            return []
        ready = [r for q in self._queues.values() for r in q
                 if r.not_before <= now]
        order = sorted(ready, key=self._admission_key)
        out = []
        for slot, req in zip(free, order):
            if self._slots[slot] is not None or req.state != QUEUED:
                raise RuntimeError(f"slot {slot} double-assigned or request "
                                   f"{req.rid} re-admitted")
            self._queues[req.klass].remove(req)
            self._slots[slot] = req
            req.state = RUNNING
            req.slot = slot
            req.started_at = now
            self.admitted_order.append(req.rid)
            out.append((slot, req))
        return out

    def release(self, slot: int) -> None:
        req = self._slots[slot]
        if req is None:
            raise RuntimeError(f"release of a free slot {slot}")
        self._slots[slot] = None
        req.slot = None

    def preempt_victim(self, for_rank: int = 0) -> tuple[int, Request] | None:
        """The running request a queued rank-`for_rank` request should
        displace: strictly lower priority (higher rank) than the claimant,
        preferring the lowest class and, within it, the most recently
        started (least sunk work lost). None when nothing qualifies."""
        victims = [(s, r) for s, r in self.running_requests()
                   if r.state == RUNNING and r.rank > for_rank]
        if not victims:
            return None
        # rid breaks started_at ties (same-round admissions share a
        # timestamp): the later submission has the least sunk work
        return max(victims, key=lambda sr: (sr[1].rank,
                                            sr[1].started_at or 0.0,
                                            sr[1].rid))

    # -- views -----------------------------------------------------------
    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def queued_by_class(self) -> dict[str, int]:
        return {k: len(q) for k, q in self._queues.items()}

    def queued_requests(self) -> Iterator[Request]:
        for k in CLASSES:
            yield from self._queues[k]

    @property
    def running(self) -> int:
        return sum(r is not None for r in self._slots)

    def running_requests(self) -> Iterator[tuple[int, Request]]:
        for i, r in enumerate(self._slots):
            if r is not None:
                yield i, r

    @property
    def busy(self) -> bool:
        return self.queued > 0 or self.running > 0

    def load_view(self) -> dict:
        """Host-side load snapshot for the two-level placement layer
        (`runtime/groups.py`): how much of this slot pool's capacity is
        spoken for, in plain scalars, so that `MeshScheduler` scores
        groups without touching the scheduler's internals."""
        usable = self.usable_slots
        return {"usable_slots": usable,
                "free_slots": len(self.free_slots()),
                "running": self.running,
                "queued": self.queued,
                "max_queue": self.max_queue,
                "occupancy": self.running / max(usable, 1)}


# ----------------------------------------------------------------------------
# Durability: Request <-> JSON (session snapshots)
# ----------------------------------------------------------------------------

def serialize_request(req: Request) -> dict:
    """JSON-able image of a request for the session snapshot. Wall-clock
    timestamps and preemption device snapshots are deliberately dropped:
    times from a dead process are meaningless, and a preempted request
    re-prefills on restore (journal-committed tokens are suppressed, so
    delivery stays exactly-once and bit-identical either way)."""
    return {"rid": req.rid, "prompt": req.prompt.tolist(),
            "max_new": req.max_new, "klass": req.klass,
            "deadline_s": req.deadline_s, "state": req.state,
            "slot": req.slot, "tokens": list(req.tokens),
            "hit_eos": req.hit_eos, "fail_reason": req.fail_reason,
            "wait_rounds": req.wait_rounds, "retries": req.retries,
            "preemptions": req.preemptions,
            "prefix_pages_expected": req.prefix_pages_expected,
            "suppress_until": req.suppress_until,
            "had_snapshot": req.snapshot is not None}


def deserialize_request(d: dict) -> Request:
    """Inverse of `serialize_request` (fresh timestamps, no device
    snapshot — see there)."""
    req = Request(rid=int(d["rid"]),
                  prompt=np.asarray(d["prompt"], np.int32),
                  max_new=int(d["max_new"]), klass=str(d["klass"]),
                  deadline_s=d.get("deadline_s"))
    req.state = str(d["state"])
    req.slot = d.get("slot")
    req.tokens = [int(t) for t in d.get("tokens", [])]
    req.hit_eos = bool(d.get("hit_eos", False))
    req.fail_reason = d.get("fail_reason")
    req.wait_rounds = int(d.get("wait_rounds", 0))
    req.retries = int(d.get("retries", 0))
    req.preemptions = int(d.get("preemptions", 0))
    req.prefix_pages_expected = int(d.get("prefix_pages_expected", 0))
    req.suppress_until = int(d.get("suppress_until", 0))
    return req

"""Request-level slot scheduler (the port of `repro.runtime.scheduler`):
one bounded FIFO request queue and a slot table.

Invariants: a slot holds at most one running request; requests are
admitted in submit order, each at most once; `submit` raises `QueueFull`
past `max_queue`; cancelling a queued request removes it, cancelling a
running one marks it for the serve loop to free at the next chunk boundary.

Priority classes, aging, shedding, preemption and retries belong to the
SLO layer (ROADMAP Queue 1 item 8): only the default class "latency" is
accepted until then.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
FAILED = "failed"

REASON_CANCELLED = "cancelled"
REASON_POOL = "pool_exhausted"      # paged KV: request can never fit


class QueueFull(RuntimeError):
    """The session's bounded request queue is at capacity (backpressure)."""


class RequestFailed(RuntimeError):
    """`result()` on a request that did not complete: carries the typed
    `reason` and the tokens emitted before the failure."""

    def __init__(self, rid: int, reason: str, partial_tokens=None):
        super().__init__(f"request {rid} failed: {reason}")
        self.rid = rid
        self.reason = reason
        self.partial_tokens = np.asarray(
            [] if partial_tokens is None else partial_tokens, np.int32)


@dataclasses.dataclass
class Request:
    """One decode request moving through the slot pool."""

    rid: int
    prompt: np.ndarray                      # (P,) int32, P >= 1
    max_new: int
    klass: str = "latency"
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    state: str = QUEUED
    slot: int | None = None
    tokens: list = dataclasses.field(default_factory=list)
    started_at: float | None = None
    first_token_at: float | None = None
    finished_at: float | None = None
    hit_eos: bool = False
    fail_reason: str | None = None

    @property
    def emitted(self) -> int:
        return len(self.tokens)


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
        """Completed tokens; raises `RequestFailed` for a cancelled or
        failed request."""
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
        return None if r.first_token_at is None else \
            r.first_token_at - r.submitted_at

    @property
    def latency_s(self) -> float | None:
        r = self._req
        return None if r.finished_at is None else \
            r.finished_at - r.submitted_at

    def __repr__(self) -> str:
        return (f"RequestHandle(id={self.id}, state={self.state}, "
                f"emitted={self._req.emitted})")


class SlotScheduler:
    """A bounded FIFO queue + slot table. Host-side bookkeeping only."""

    def __init__(self, n_slots: int, *, max_queue: int | None = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self._queue: deque[Request] = deque()
        self._slots: list[Request | None] = [None] * n_slots
        self._next_rid = 0
        self.admitted_order: deque[int] = deque(maxlen=4096)
        self.queue_peak = 0

    def submit(self, prompt, max_new: int, *,
               klass: str = "latency") -> Request:
        if klass != "latency":
            raise NotImplementedError(
                f"request class {klass!r}: priority classes come with the "
                f"SLO layer (ROADMAP Queue 1 item 8)")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFull(f"the request queue is at capacity "
                            f"({self.max_queue}); drain or poll first")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new)
        self._next_rid += 1
        self._queue.append(req)
        self.queue_peak = max(self.queue_peak, self.queued)
        return req

    def fail(self, req: Request, reason: str) -> None:
        """Terminal failure. Queued requests are dequeued; the caller
        releases the slot of a running one."""
        if req.state == QUEUED:
            self._queue.remove(req)
        req.state = FAILED
        req.fail_reason = reason
        req.finished_at = time.perf_counter()

    def cancel(self, req: Request) -> bool:
        """Queued -> removed now; running -> marked for the serve loop.
        Returns False if the request is already over."""
        if req.state == QUEUED:
            self._queue.remove(req)
        elif req.state != RUNNING:
            return False
        req.state = CANCELLED
        req.finished_at = time.perf_counter()
        return True

    def requeue(self, req: Request) -> None:
        """Put a released request back in the queue (a paged admission the
        pool could not cover yet); admission order is submit order."""
        if req.slot is not None:
            raise RuntimeError("requeue before release")
        req.state = QUEUED
        self._queue.appendleft(req)
        self.queue_peak = max(self.queue_peak, self.queued)

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def admit(self, now: float | None = None) -> list[tuple[int, Request]]:
        """Assign queued requests to free slots in submit order (a
        requeued request keeps its place). Returns [(slot, request)],
        already RUNNING."""
        now = time.perf_counter() if now is None else now
        order = sorted(self._queue, key=lambda r: r.rid)
        out = []
        for slot, req in zip(self.free_slots(), order):
            self._queue.remove(req)
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

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def running(self) -> int:
        return sum(r is not None for r in self._slots)

    def running_requests(self):
        for i, r in enumerate(self._slots):
            if r is not None:
                yield i, r

    @property
    def busy(self) -> bool:
        return self.queued > 0 or self.running > 0

"""Serving loops: batch programs (`ServeLoop`) and request-level
continuous batching (`ServeSession`; the core of
`repro.runtime.serve_loop`).

`ServeLoop` is the fixed-batch loop: one rectangular batch of prompts
runs to completion, one host sync a token (`chunk=1`) or one a K-step
chunk of the `DecodeEngine` (`engine.py`).

`ServeSession` steps a fixed slot pool by the session chunk; between
chunks the host harvests emitted tokens, frees finished slots, admits
queued requests and refills their slots — installing page tables under a
paged KV pool, with copy-on-write prefix reuse. Private and paged caches
are both served, with the reference's robustness and durability layer:
priority classes, shedding, preemption, fault plans and their recovery,
the watchdog, the NaN scan, page checksums and the scrub, the request
journal and session snapshots with crash restore.

On the card the session step is a captured CUDA graph that replays on
the addresses it was captured on, so every operation that changes the
session state (refill, slot restore, NaN corruption, page flip and
scrub, snapshot restore) writes in place; none rebinds a tensor.
"""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.compile_cache import Graphed, tensor_leaves
from repro_torch.runtime.engine import DecodeEngine, StallClock
from repro_torch.runtime.faults import (FaultPlan, SessionCrashed,
                                        SessionWedged)
from repro_torch.runtime.journal import Journal, read_events, replay
from repro_torch.runtime.kvpool import PagedKV, PoolExhausted, page_digests
from repro_torch.runtime.scheduler import (CANCELLED, CLASSES, DONE, FAILED,
                                           QUEUED, REASON_CANCELLED,
                                           REASON_POOL, REASON_RETRIES,
                                           REASON_SHED, RUNNING, Request,
                                           RequestHandle, SlotScheduler,
                                           deserialize_request,
                                           serialize_request)

HISTORY = 4096          # sliding-window length for session stats records


def chunked_latency_stats(samples) -> dict:
    """Per-token latency stats from `(seconds, steps)` chunk samples.

    The first sample is dropped (it carries the warm-up and the graph's
    capture); with zero post-warm-up samples the figures report 0.0 rather
    than fake `1/epsilon` numbers. Shared by `ServeLoop.stats` (engine
    path) and the session's legacy-shaped one-shot stats."""
    samples = list(samples)
    lat = np.asarray([dt for dt, _ in samples[1:]], np.float64)
    steps = np.asarray([n for _, n in samples[1:]], np.int64)
    tokens = int(steps.sum())
    if lat.size == 0 or tokens == 0:
        return {"decode_steps": 0, "p50_ms": 0.0, "p99_ms": 0.0,
                "tokens_per_s_per_slot": 0.0}
    per_tok = lat / np.maximum(steps, 1)
    return {"decode_steps": tokens,
            "p50_ms": float(np.percentile(per_tok, 50) * 1e3),
            "p99_ms": float(np.percentile(per_tok, 99) * 1e3),
            "tokens_per_s_per_slot": float(tokens / max(lat.sum(), 1e-9))}


class ServeLoop:
    """Greedy batched decoding of one fixed batch.

    `decode_step(params, cache, batch) -> (cache, token (B, 1))`. On the
    card the per-token path replays one captured step (the step is wrapped
    in `Graphed` unless it is one already: the reference's callers jit it).

    `eos_id` (None disables): a slot that emits EOS is *finished* — its
    subsequent tokens are masked to EOS, it stops counting toward emitted
    lengths, and the loop stops early once every slot has finished.

    `chunk` picks the execution engine: 1 (default) is the per-token host
    loop — one dispatch + one host sync per token; K > 1 runs K decode
    steps as one program of the `DecodeEngine` (one CUDA graph on the
    card), so the host syncs once per K tokens. Both paths produce
    bit-identical tokens, EOS behaviour and emitted counts. The cache is
    updated in place on both.
    """

    def __init__(self, decode_step: Callable, params, cache, batch_size: int,
                 eos_id: int | None = None, chunk: int = 1,
                 engine: DecodeEngine | None = None):
        if not isinstance(decode_step, Graphed):
            decode_step = Graphed(decode_step, copied=(2,))
        self.decode_step = decode_step
        self.params = params
        self.cache = cache
        self.batch_size = batch_size
        self.eos_id = eos_id
        self.latencies: list[float] = []
        self.emitted_lengths: np.ndarray | None = None
        self._finished: np.ndarray | None = None
        self._chunk_steps: list[int] | None = None
        self.clock = StallClock()
        # a prebuilt engine (kept on a compiled program so that its graphs
        # are captured once, not per generate) wins over `chunk`
        if engine is None and chunk > 1:
            engine = DecodeEngine(decode_step, chunk, eos_id=eos_id)
        self._engine = engine
        self.chunk = engine.chunk if engine is not None else chunk

    def generate(self, prompt_tokens: np.ndarray, max_new: int,
                 start_pos: int = 0) -> np.ndarray:
        """prompt_tokens: (B, 1) last prompt token per slot."""
        if self._engine is not None:
            return self._generate_chunked(prompt_tokens, max_new, start_pos)
        prompt_tokens = np.asarray(prompt_tokens, np.int32)
        B = prompt_tokens.shape[0]
        out = np.empty((B, 1 + max_new), np.int32)       # one host buffer
        out[:, 0] = prompt_tokens[:, 0]
        dev = next(tensor_leaves(self.cache)).device
        tok = torch.as_tensor(prompt_tokens, device=dev)
        finished = np.zeros(B, bool)
        emitted = np.zeros(B, np.int64)
        pos = start_pos
        self.latencies = []
        self.clock = StallClock()
        w = 0
        for _ in range(max_new):
            t0 = self.clock.dispatch()
            self.cache, tok = self.decode_step(self.params, self.cache,
                                               {"tokens": tok, "pos": pos})
            self.clock.sync(tok)
            self.latencies.append(time.perf_counter() - t0)
            step_tok = tok.cpu().numpy().astype(np.int32)
            emitted += ~finished
            if self.eos_id is not None:
                # already-finished slots hold EOS regardless of the argmax
                step_tok = np.where(finished[:, None], self.eos_id, step_tok)
                finished |= step_tok[:, 0] == self.eos_id
                tok = torch.as_tensor(step_tok.astype(np.int32), device=dev)
            out[:, 1 + w] = step_tok[:, 0]
            w += 1
            pos += 1
            if self.eos_id is not None and finished.all():
                break
        self.emitted_lengths = emitted
        self._finished = finished
        self._chunk_steps = None
        return out[:, :1 + w]

    def _generate_chunked(self, prompt_tokens, max_new: int,
                          start_pos: int) -> np.ndarray:
        out, cache, finished, emitted = self._engine.generate(
            self.params, self.cache, prompt_tokens, max_new, start_pos)
        self.cache = cache
        self.clock = self._engine.clock
        self.latencies = [dt for dt, _ in self._engine.chunk_latencies]
        self._chunk_steps = [n for _, n in self._engine.chunk_latencies]
        self.emitted_lengths = emitted
        self._finished = finished
        return out

    def stats(self) -> dict:
        """Latency stats over the post-warm-up steps (the first step, or
        the first chunk on the engine path, is dropped: it carries the
        warm-up and the capture). With zero or one recorded sample there
        are no measured steps, so throughput and percentiles report 0.0;
        `decode_steps` counts the decode steps the measured samples cover.
        After a `generate`, `emitted_per_slot` reports how many tokens each
        slot emitted before (and including) its EOS, and `finished_slots`
        how many slots hit EOS. `stall` carries the StallClock ledger."""
        lat = np.asarray(self.latencies[1:], np.float64)
        if self._chunk_steps is not None:
            st = chunked_latency_stats(zip(self.latencies, self._chunk_steps))
        elif lat.size == 0:
            st = {"decode_steps": 0, "p50_ms": 0.0, "p99_ms": 0.0,
                  "tokens_per_s_per_slot": 0.0}
        else:
            st = {"decode_steps": int(lat.size),
                  "p50_ms": float(np.percentile(lat, 50) * 1e3),
                  "p99_ms": float(np.percentile(lat, 99) * 1e3),
                  "tokens_per_s_per_slot": float(1.0 / max(lat.mean(), 1e-9))}
        st["chunk"] = self.chunk
        st["stall"] = self.clock.report()
        if self.emitted_lengths is not None:
            st["emitted_per_slot"] = [int(n) for n in self.emitted_lengths]
            if self.eos_id is not None:
                st["finished_slots"] = int(self._finished.sum())
        return st




# ----------------------------------------------------------------------------
# Request-level serving: continuous batching over a slot pool
# ----------------------------------------------------------------------------


def _class_counters() -> dict:
    return {"submitted": 0, "done": 0, "cancelled": 0, "failed": 0,
            "shed": 0, "preempted": 0, "retries": 0, "deadline_miss": 0,
            "ttfts": deque(maxlen=HISTORY), "lats": deque(maxlen=HISTORY)}


def _no_tokens() -> np.ndarray:
    return np.empty(0, np.int32)


WATCHDOG_POLL_S = 5e-5     # how often the watchdog asks the chunk's event


class ServeSession:
    """A long-lived slot pool serving a stream of independent requests::

        sess = cluster.compile(ServeSessionProgram(slots=8)).open()
        h = sess.submit(prompt, max_new=64, klass="latency",
                        deadline_s=0.5)            # -> RequestHandle
        for handle, toks, done in sess.stream():   # incremental tokens
            ...
        sess.drain()                               # run queue dry
        h.result()                                 # (T,) np.int32

    The device side is the session chunk (`chunk_fn`, on the card one
    captured step replayed K times) plus a refill (`refill_fn`) that
    recycles finished slots in place. The host wakes once per chunk:
    harvest, free finished slots, admit queued requests, dispatch.

    Robustness layer (the MemPool stance — one stalled PE never wedges
    the cluster, a dead PE only costs its own lanes):

    * **priority classes** — ``klass`` ("latency" | "throughput" |
      "best_effort") and an optional ``deadline_s``; class-ranked
      admission with aging, overload sheds only best-effort work;
    * **preemption** — a ready latency request behind a full pool
      snapshots the lowest-priority running slot (`snapshot_fn`, a copy
      on the card), requeues it at the front of its class and takes the
      slot; the victim resumes bit for bit (`restore_fn`, in place);
    * **fault detection + recovery** — the NaN scan (`nan_check`) and a
      `FaultPlan` (`faults=`) feed a recovery path that quarantines dead
      slots, discards poisoned output and requeues the victim with
      bounded retries and exponential backoff;
    * **watchdog** — `poll(timeout_s=...)` (or ``watchdog_s``) bounds each
      chunk's device wait: a CUDA event recorded after the chunk is
      polled until the deadline (`torch.cuda.synchronize` cannot be
      bounded), and `SessionWedged` is raised past it;
      `recover_wedged()` rebuilds the pool from ``state_factory``;
    * **integrity + durability** — page checksums stamped at publish and
      verified at admission and by the scrub, the request journal
      (`durable_dir`) and periodic session snapshots (`snapshot_every`),
      `resume=True` restoring after a crash with exactly-once delivery;
    * **per-class SLO accounting** in `stats()["classes"]`.

    `captures` counts the session step graphs this session captured: one
    at the first chunk on the card, and one more after each
    `recover_wedged` (its fresh state captures anew)."""

    def __init__(self, chunk_fn: Callable, refill_fn: Callable, params,
                 state: dict, *, n_slots: int, chunk: int,
                 max_prompt: int, max_seq: int | None = None,
                 eos_id: int | None = None, max_queue: int | None = None,
                 admission: str = "fifo",
                 shed_watermark: int | None = None, aging_rounds: int = 8,
                 preempt: bool = True,
                 snapshot_fn: Callable | None = None,
                 restore_fn: Callable | None = None,
                 nan_scan_fn: Callable | None = None,
                 corrupt_fn: Callable | None = None,
                 state_factory: Callable | None = None,
                 watchdog_s: float | None = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.05,
                 nan_check: bool = False,
                 faults: "FaultPlan | None" = None,
                 kv: "PagedKV | None" = None,
                 page_copy_fn: Callable | None = None,
                 page_scrub_fn: Callable | None = None,
                 durable_dir: "str | Path | None" = None,
                 snapshot_every: int | None = None,
                 journal_fsync: bool | int = True,
                 page_read_fn: Callable | None = None,
                 page_flip_fn: Callable | None = None,
                 scrub_pages: int = 2,
                 crash_hook: Callable | None = None,
                 resume: bool = False,
                 journal_group: int | None = None):
        if kv is not None and preempt:
            raise ValueError("paged KV serving does not support slot "
                             "preemption (slot snapshots do not carry page "
                             "tables); open the session with preempt=False")
        self._chunk_fn = chunk_fn
        self._refill_fn = refill_fn
        self.params = params
        self.state = state
        self.n_slots = n_slots
        self.chunk = chunk
        self.max_prompt = max_prompt
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.preempt = preempt
        self.watchdog_s = watchdog_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.kv = kv
        self._page_copy_fn = page_copy_fn
        self._page_scrub_fn = page_scrub_fn
        self.scheduler = SlotScheduler(
            n_slots, max_queue=max_queue, policy=admission,
            shed_watermark=shed_watermark, aging_rounds=aging_rounds,
            prefix_score=kv.match_len if kv is not None else None,
            page_size=kv.pool.page_size if kv is not None else None)
        self.clock = StallClock()
        # checkpoint/restore + fault programs, built for the cache's
        # layout by the caller (`_fault_fn` raises for a missing one)
        self._snapshot_fn = snapshot_fn
        self._restore_fn = restore_fn
        self._nan_scan_fn = nan_scan_fn
        self._corrupt_fn = corrupt_fn
        self._state_factory = state_factory
        self._nan_check = nan_check
        self._faults = faults
        self._wedged = False
        self._chunk_index = 0
        self._refill_failures = 0
        self.captures = 0
        self.chunk_latencies: deque[tuple[float, int]] = deque(
            maxlen=HISTORY)
        self.handles: dict[int, RequestHandle] = {}    # in-flight only
        self._pending_release: set[int] = set()
        # slots whose request completed cleanly: their prompt pages seed
        # the prefix cache before the pages are released (paged only)
        self._pending_publish: set[int] = set()
        self._n_pool_exhausted = 0
        # host table freed but device row still active (preempted or dead
        # slots): folded into the next refill's release mask
        self._pending_deactivate: set[int] = set()
        self._pending_events: list = []     # terminal events awaiting poll
        self._busy_steps = 0
        self._total_steps = 0
        self._emitted_total = 0
        self._per_chunk_emitted: deque[int] = deque(maxlen=HISTORY)
        self._ttfts: deque[float] = deque(maxlen=HISTORY)
        self._latencies: deque[float] = deque(maxlen=HISTORY)
        self._n_done = 0
        self._n_cancelled = 0
        self._n_failed = 0
        self._n_preemptions = 0
        self._n_retries = 0
        self._deadline_miss = 0
        self._class_stats = {k: _class_counters() for k in CLASSES}
        # -- durability + integrity ---------------------------------------
        # the journal is a write-ahead log of the request lifecycle: a
        # token is delivered only after its commit record is durable, so
        # a restart replays to a consistent state with exactly-once
        # delivery (greedy decode regenerates committed prefixes; harvest
        # suppresses them instead of delivering them again)
        self._durable_dir = Path(durable_dir) if durable_dir else None
        self._snapshot_every = snapshot_every
        self._page_read_fn = page_read_fn
        self._page_flip_fn = page_flip_fn
        self._scrub_pages = scrub_pages
        self._crash_hook = crash_hook
        self._journal: Journal | None = None
        self._ckpt: CheckpointManager | None = None
        self._snapshots_taken = 0
        self._last_snapshot_chunk = -1
        self._restored_step: int | None = None
        self._replayed_requests = 0         # live requests reinstalled
        self._resubmitted = 0               # of those, requeued (re-prefill)
        self._deduped_tokens = 0            # regenerated but suppressed
        self._restore_s = 0.0               # measured MTTR of _recover()
        self._prefix_pages_expected = 0     # admission-predicted page reuse
        # requests that finished before a crash, rebuilt from the journal
        self.recovered: dict[int, RequestHandle] = {}
        self._journal_group = journal_group
        if self._durable_dir is not None:
            self._durable_dir.mkdir(parents=True, exist_ok=True)
            if resume:
                self._recover()
            self._journal = Journal(self._durable_dir / "journal.jsonl",
                                    fsync=journal_fsync,
                                    tag=(None if journal_group is None
                                         else {"group": journal_group}))
            if resume:
                self._journal.append({
                    "ev": "restore",
                    "snapshot_step": self._restored_step,
                    "replayed": self._replayed_requests,
                    "restore_s": self._restore_s})
                self._journal.commit()

    # -- fault/checkpoint programs ---------------------------------------
    def _fault_fn(self, name: str) -> Callable:
        """The `name` program the session was built with (`snapshot_fn`,
        `restore_fn`, `nan_scan_fn`, `corrupt_fn`). Each depends on the
        cache's layout, so none has a default: `CompiledServeSession`
        builds them for its private or paged cache."""
        fn = getattr(self, "_" + name)
        if fn is None:
            raise RuntimeError(f"this session was built without {name}= "
                               f"(CompiledServeSession builds it for the "
                               f"cache's layout)")
        return fn

    def attach_faults(self, plan: FaultPlan) -> None:
        """Arm a `FaultPlan` against this session (chaos testing)."""
        self._faults = plan

    # -- request lifecycle ----------------------------------------------
    def submit(self, prompt, max_new: int, *, klass: str = "latency",
               deadline_s: float | None = None) -> RequestHandle:
        """Enqueue one request; admitted to a slot at a chunk boundary.

        `klass` picks the priority class; `deadline_s` is the SLO deadline
        counted from now (per-class deadline-miss accounting). Raises
        `scheduler.QueueFull` when the class queue is full. Under overload
        (`shed_watermark`) a best-effort submission may come back already
        failed with reason "shed"."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size > self.max_prompt:
            raise ValueError(f"prompt of {prompt.size} tokens exceeds the "
                             f"session's max_prompt={self.max_prompt}")
        # the request's last KV write lands at position P + max_new - 2
        if (self.max_seq is not None
                and prompt.size + max_new - 1 > self.max_seq):
            raise ValueError(f"prompt ({prompt.size}) + max_new ({max_new}) "
                             f"exceeds the session's max_seq={self.max_seq}")
        req = self.scheduler.submit(prompt, max_new, klass=klass,
                                    deadline_s=deadline_s)
        self._class_stats[klass]["submitted"] += 1
        if self._journal is not None:
            self._journal.append({
                "ev": "submit", "rid": req.rid, "prompt": prompt.tolist(),
                "max_new": int(max_new), "klass": klass,
                "deadline_s": deadline_s})
        handle = RequestHandle(req)
        if not handle.done:             # the submission itself may have
            self.handles[req.rid] = handle      # been shed under overload
        self._retire_shed(self._pending_events)
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Queued: removed now. Running: its slot is freed at the next
        chunk boundary."""
        was_queued = handle.state == QUEUED
        ok = self.scheduler.cancel(handle._req)
        if ok:
            self._n_cancelled += 1
            self._class_stats[handle.klass]["cancelled"] += 1
            if self._journal is not None:
                self._journal.append({
                    "ev": "finish", "rid": handle.id,
                    "status": "cancelled", "reason": REASON_CANCELLED})
                self._journal.commit()
            if was_queued:
                self.handles.pop(handle.id, None)
        return ok

    # -- the chunk boundary ---------------------------------------------
    def _retire_shed(self, events: list) -> None:
        """Surface requests the scheduler shed as terminal events (empty
        payload, done=True) and count them per class."""
        for req in self.scheduler.pop_shed():
            self._class_stats[req.klass]["shed"] += 1
            if self._journal is not None:
                self._journal.append({"ev": "finish", "rid": req.rid,
                                      "status": "failed",
                                      "reason": REASON_SHED})
            handle = self.handles.pop(req.rid, None)
            if handle is not None:
                events.append((handle, _no_tokens(), True))

    def _fail_request(self, req, reason: str, events: list) -> None:
        self.scheduler.fail(req, reason)
        if self._journal is not None:
            self._journal.append({"ev": "finish", "rid": req.rid,
                                  "status": "failed", "reason": reason})
        self._class_stats[req.klass]["failed"] += 1
        self._n_failed += 1
        handle = self.handles.pop(req.rid, None)
        if handle is not None:
            events.append((handle, _no_tokens(), True))

    def _restart_request(self, req, events: list) -> None:
        """A running request whose slot died: discard its poisoned partial
        output (greedy decode reproduces it bit for bit) and requeue it
        with bounded retries and exponential backoff; past `max_retries`
        it fails with reason "retries_exhausted"."""
        req.tokens.clear()
        req.hit_eos = False
        req.snapshot = None
        req.retries += 1
        if req.retries > self.max_retries:
            self._fail_request(req, REASON_RETRIES, events)
            return
        self._class_stats[req.klass]["retries"] += 1
        self._n_retries += 1
        backoff = self.retry_backoff_s * (2 ** (req.retries - 1))
        self.scheduler.requeue(req, front=False, backoff_s=backoff)

    def _recover_slot(self, slot: int, quarantine: bool,
                      events: list) -> None:
        """A slot found dead (kill fault) or poisoned (NaN scan) at
        harvest: free it before any of its output is surfaced.
        `quarantine=True` retires it for good; False recycles it."""
        req = self.scheduler._slots[slot]
        if req is not None:
            self.scheduler.release(slot)
        self._pending_deactivate.add(slot)
        if self.kv is not None:
            # the slot's pages may hold NaN: scrubbed before reuse
            self.kv.release(slot, dirty=True)
        if quarantine:
            self.scheduler.quarantine(slot)
        if req is None:
            return
        if req.state == RUNNING:
            self._restart_request(req, events)
        else:                               # cancelled mid-flight: retire
            self.handles.pop(req.rid, None)

    def _preempt_for_latency(self) -> None:
        """Snapshot the lowest-priority running slots so that ready latency
        requests behind a full pool get in this boundary. The victim's
        snapshot is a copy on the card (the slot's cache rows and
        counters); it is requeued at the front of its class with its aging
        reset and resumes through `restore_fn` when capacity frees."""
        now = time.perf_counter()
        ready_lat = [r for r in self.scheduler._queues["latency"]
                     if r.not_before <= now]
        if not ready_lat:
            return
        need = len(ready_lat) - len(self.scheduler.free_slots())
        for _ in range(max(need, 0)):
            victim = self.scheduler.preempt_victim(for_rank=0)
            if victim is None:
                break
            slot, req = victim
            req.snapshot = self._fault_fn("snapshot_fn")(self.state, slot)
            req.preemptions += 1
            req.wait_rounds = 0     # resume on capacity, not aging boost
            self._class_stats[req.klass]["preempted"] += 1
            self._n_preemptions += 1
            self.scheduler.release(slot)
            self._pending_deactivate.add(slot)
            self.scheduler.requeue(req, front=True)

    def _alloc_pages(self, fresh: list, events: list) -> list:
        """Paged admission: build each fresh slot's page table. A request
        the pool cannot cover now is un-admitted and requeued at the
        front; when the pool is idle and empty and it still does not fit,
        it fails with "pool_exhausted". A scripted `page_alloc_fail`
        forces the exhausted path for one boundary (always a requeue)."""
        forced = (self._faults is not None
                  and self._faults.page_alloc_failed(self._chunk_index))
        # shared prefix pages are checksum-verified before a new request
        # may attach to them; a mismatch quarantines the page and the
        # admission falls back to fresh pages (recompute repairs it)
        verify = (self._verify_pages if self._page_read_fn is not None
                  else None)
        kept: list = []
        for slot, req in fresh:
            try:
                if forced:
                    raise PoolExhausted(0, self.kv.pool.free_pages)
                alloc = self.kv.admit(slot, req.prompt, req.max_new,
                                      verify=verify)
                self._prefix_pages_expected += req.prefix_pages_expected
            except PoolExhausted:
                self._n_pool_exhausted += 1
                self.scheduler.release(slot)
                if (not forced and not kept
                        and self.scheduler.running == 0
                        and self.kv.pool.used_pages == 0):
                    self._fail_request(req, REASON_POOL, events)
                else:
                    self.scheduler.requeue(req, front=True)
                continue
            kept.append((slot, req, alloc))
        return kept

    def _admit_and_refill(self, events: list) -> None:
        for slot, req in list(self.scheduler.running_requests()):
            if req.state != RUNNING:            # cancelled mid-flight
                self._pending_release.add(slot)
                self.handles.pop(req.rid, None)
        for slot in self._pending_release:
            self.scheduler.release(slot)
            self._pending_deactivate.add(slot)
            if self.kv is not None:
                if slot in self._pending_publish:
                    # seed the prefix cache; stamp each published page's
                    # content checksum for later admits and the scrub
                    digests = None
                    if self._page_read_fn is not None:
                        pp = self.kv.publishable_pages(slot)
                        if pp:
                            arrs = self._page_read_fn(
                                self.state, np.asarray(pp, np.int64))
                            digests = dict(
                                zip(pp, page_digests(arrs, len(pp))))
                    self.kv.publish(slot, digests=digests)
                self.kv.release(slot)
        self._pending_release.clear()
        self._pending_publish.clear()
        self._retire_shed(events)       # sheds triggered since last poll
        if self.kv is not None:
            # pages freed from a corrupted slot may hold NaN, the one thing
            # masked attention cannot hide: scrub before reuse
            dirty = self.kv.pool.take_dirty_free()
            if dirty:
                self._page_scrub_fn(self.state, np.asarray(dirty, np.int64))
        if self.preempt:
            self._preempt_for_latency()
        admits = self.scheduler.admit()
        if not admits and not self._pending_deactivate:
            return
        release = np.zeros(self.n_slots, bool)
        if self._pending_deactivate:
            release[sorted(self._pending_deactivate)] = True
        fresh = [(s, r) for s, r in admits if r.snapshot is None]
        resumed = [(s, r) for s, r in admits if r.snapshot is not None]
        kv_fresh = []
        if self.kv is not None and fresh:
            kv_fresh = self._alloc_pages(fresh, events)
            fresh = [(s, r) for s, r, _ in kv_fresh]
        granted = fresh + resumed       # still slot-assigned after alloc
        try:
            if self._faults is not None:
                self._faults.check_refill(self._chunk_index)
            if fresh or release.any():
                admit = np.zeros(self.n_slots, bool)
                pbuf = np.zeros((self.n_slots, self.max_prompt), np.int32)
                plen = np.zeros(self.n_slots, np.int32)
                budget = np.zeros(self.n_slots, np.int32)
                for slot, req in fresh:
                    admit[slot] = True
                    pbuf[slot, :req.prompt.size] = req.prompt
                    plen[slot] = req.prompt.size
                    budget[slot] = req.max_new
                if self.kv is not None:
                    pages = np.zeros((self.n_slots, self.kv.pages_per_slot),
                                     np.int32)
                    start = np.zeros(self.n_slots, np.int32)
                    cow_src: list[int] = []
                    cow_dst: list[int] = []
                    for slot, req, alloc in kv_fresh:
                        pages[slot] = alloc.table
                        start[slot] = alloc.prefill_skip
                        for s, d in alloc.cow_copies:
                            cow_src.append(s)
                            cow_dst.append(d)
                    self._refill_fn(self.state, admit, release, pbuf, plen,
                                    budget, pages, start)
                    if cow_src:     # COW fork: copy before the next chunk
                        self._page_copy_fn(self.state,
                                           np.asarray(cow_src, np.int64),
                                           np.asarray(cow_dst, np.int64))
                else:
                    self._refill_fn(self.state, admit, release, pbuf, plen,
                                    budget)
            for slot, req in resumed:
                self._fault_fn("restore_fn")(self.state, slot, req.snapshot)
                req.snapshot = None
            self._pending_deactivate.clear()
            self._refill_failures = 0
            if self._journal is not None:
                for slot, req in granted:
                    self._journal.append({"ev": "admit", "rid": req.rid,
                                          "slot": slot,
                                          "chunk": self._chunk_index})
        except Exception:
            # un-admit the round (reverse order restores queue positions);
            # pending deactivations retry at the next boundary. Bounded:
            # a refill that keeps failing must surface, not spin forever.
            for slot, req in reversed(granted):
                if self.kv is not None:
                    self.kv.release(slot)
                self.scheduler.release(slot)
                self.scheduler.requeue(req, front=True)
            self._refill_failures += 1
            if self._refill_failures > self.max_retries:
                raise

    def _watchdog_wait(self, done, timeout: float, chunk_idx: int,
                       wedge: bool) -> None:
        """Bound the chunk's device wait by `timeout` seconds. `done` is a
        CUDA event recorded right after the chunk was dispatched (None on
        the CPU, where the chunk already ran): it is polled until it
        completes or the deadline passes. An injected wedge never polls
        it, exactly what a hung device looks like from the host."""
        t0 = time.perf_counter()
        deadline = t0 + timeout
        while wedge or (done is not None and not done.query()):
            now = time.perf_counter()
            if now >= deadline:
                self._wedged = True
                raise SessionWedged(chunk_idx, timeout, self.clock.report())
            time.sleep(min(WATCHDOG_POLL_S, deadline - now))
        self.clock.sync_done(t0)

    def _handle_idle_queue(self, events: list) -> None:
        """Nothing running but work queued: either the pool is fully
        quarantined (fail everything: it can never run) or every queued
        request is gated by retry backoff (sleep to the earliest gate and
        re-admit, so that drain() cannot livelock)."""
        if not self.scheduler.queued:
            return
        if self.scheduler.usable_slots == 0:
            for req in list(self.scheduler.queued_requests()):
                self._fail_request(req, REASON_RETRIES, events)
            return
        gates = [r.not_before for r in self.scheduler.queued_requests()]
        wait = min(gates) - time.perf_counter()
        if wait > 0:
            time.sleep(min(wait, 0.25))
        self._admit_and_refill(events)

    def recover_wedged(self) -> None:
        """Recover from `SessionWedged`: give up the wedged buffers and
        build a fresh pool state from ``state_factory`` (a new state
        holds no step graph, so its first chunk captures a new one on the
        card: `captures` counts it), requeue every running request with a
        retry charged, and clear the wedge latch. Requests past
        `max_retries` fail; their events surface on the next poll."""
        if self._state_factory is None:
            raise RuntimeError("recover_wedged() needs a state_factory "
                               "(a zero-arg callable rebuilding the pool "
                               "state); pass it to the session or open() "
                               "the program with one")
        events = self._pending_events
        for slot, req in list(self.scheduler.running_requests()):
            self.scheduler.release(slot)
            if req.state == RUNNING:
                self._restart_request(req, events)
            else:
                self.handles.pop(req.rid, None)
        self._pending_release.clear()
        self._pending_publish.clear()
        self._pending_deactivate.clear()
        self.state = self._state_factory()
        if self.kv is not None:
            self.kv.reset()     # the rebuilt pool holds no pages or tables
        self._wedged = False

    # -- durability: journal + snapshots + integrity ---------------------
    def handle(self, rid: int) -> RequestHandle | None:
        """A request's handle by id: in flight first, then `recovered`
        (requests that finished before a crash, rebuilt at restore)."""
        return self.handles.get(rid) or self.recovered.get(rid)

    def close(self) -> None:
        """Land the in-flight snapshot write and close the journal
        (idempotent)."""
        if self._ckpt is not None:
            self._ckpt.wait()
        if self._journal is not None:
            self._journal.close()

    def _verify_pages(self, pages) -> list[int]:
        """Checksum-verify pool pages against their publish stamps; the
        mismatching page ids (unstamped pages are skipped)."""
        pages = [int(p) for p in pages]
        if not pages or self._page_read_fn is None:
            return []
        arrs = self._page_read_fn(self.state, np.asarray(pages, np.int64))
        return self.kv.verify(pages, page_digests(arrs, len(pages)))

    def _inject_bit_flip(self, page: int | None) -> None:
        """The scripted silent corruption: perturb one pool page on the
        card. Defaults to the first stamped (shared) page, so that the
        checksum path, not luck, must catch it."""
        if self._page_flip_fn is None or self.kv is None:
            raise RuntimeError("a bit_flip fault needs a paged session "
                               "(kv=) with page_flip_fn")
        if page is None:
            stamped = sorted(self.kv.checksums)
            page = stamped[0] if stamped else 1
        self._page_flip_fn(self.state, np.asarray([page], np.int64))

    def _live_requests(self) -> list:
        """Every request the scheduler still holds: queued and
        slot-resident (done ones awaiting release included: their finish
        records are journaled, so restore retires them)."""
        out = list(self.scheduler.queued_requests())
        out.extend(r for _, r in self.scheduler.running_requests())
        return out

    def _get_ckpt(self) -> CheckpointManager:
        if self._ckpt is None:
            # written inline: a writer thread would contend with the poll
            # loop for the GIL
            self._ckpt = CheckpointManager(self._durable_dir / "snapshots",
                                           keep=2, async_save=False)
        return self._ckpt

    def _save_snapshot(self) -> None:
        """One bit-exact session snapshot: the state's tensors plus the
        host bookkeeping needed to resume (serialized requests, the page
        pool / prefix cache / tables, the journal high-water mark)."""
        meta = {
            "chunk_index": self._chunk_index,
            "journal_seq": self._journal.seq if self._journal else 0,
            "next_rid": self.scheduler._next_rid,
            "requests": [serialize_request(r)
                         for r in self._live_requests()],
            "quarantined_slots": self.scheduler.quarantined,
            "pending_deactivate": sorted(self._pending_deactivate),
            "kv": self.kv.snapshot() if self.kv is not None else None,
        }
        self._get_ckpt().save_session(self._chunk_index, self.state, meta)
        self._snapshots_taken += 1
        self._last_snapshot_chunk = self._chunk_index
        if self._journal is not None:
            self._journal.append({"ev": "snapshot",
                                  "step": self._chunk_index})
            self._journal.commit()

    def _recover(self) -> None:
        """Crash recovery: load the latest snapshot (if any), then replay
        the journal over it. The snapshot is copied into the live state in
        place (each tensor keeps its storage) and is authoritative for the
        device and scheduler state; the journal gives terminal statuses,
        the committed tokens of each request and the requests submitted
        after the snapshot. Requests running at the snapshot resume in
        their slot bit for bit; everything else in flight prefills anew
        with its committed tokens suppressed at harvest (exactly once).
        A torn journal tail never raises."""
        t0 = time.perf_counter()
        summary = replay(read_events(self._durable_dir / "journal.jsonl"))
        meta = None
        if (self._durable_dir / "snapshots").exists():
            step = self._get_ckpt().latest_session_step()
            if step is not None:
                ptrs = [t.data_ptr() for t in tensor_leaves(self.state)]
                _, meta = self._get_ckpt().restore_session(step,
                                                           like=self.state)
                if ptrs != [t.data_ptr() for t in tensor_leaves(self.state)]:
                    raise RuntimeError("restore moved a state tensor")
                self._restored_step = step
                self._chunk_index = int(meta["chunk_index"])
                self._last_snapshot_chunk = self._chunk_index
                self.scheduler._next_rid = int(meta["next_rid"])
                for s in meta.get("quarantined_slots") or []:
                    self.scheduler._quarantined.add(int(s))
                self._pending_deactivate.update(
                    int(s) for s in meta.get("pending_deactivate") or [])
                if self.kv is not None and meta.get("kv"):
                    self.kv.load_snapshot(meta["kv"])
        self.scheduler._next_rid = max(
            self.scheduler._next_rid,
            max(summary.requests, default=-1) + 1)
        snap_reqs = ({int(d["rid"]): d for d in meta["requests"]}
                     if meta else {})
        occupied = {int(d["slot"]) for d in snap_reqs.values()
                    if d.get("slot") is not None}
        resumed: set[int] = set()
        now = time.perf_counter()
        for rid in sorted(set(summary.requests) | set(snap_reqs)):
            rr = summary.requests.get(rid)
            d = snap_reqs.get(rid)
            committed = (rr.committed if rr is not None
                         else list(d.get("tokens") or []))
            status = rr.status if rr is not None else None
            if status is None and d is not None and d["state"] in (
                    DONE, CANCELLED, FAILED):
                status = d["state"]
            if d is not None:
                req = deserialize_request(d)
            elif rr is not None and rr.prompt is not None:
                req = Request(rid=rid,
                              prompt=np.asarray(rr.prompt, np.int32),
                              max_new=int(rr.max_new), klass=rr.klass,
                              deadline_s=rr.deadline_s)
            else:
                continue    # no submit record survived: nothing to rebuild
            if status is not None:
                # terminal before the crash: surfaced through `recovered`;
                # a slot the snapshot still held for it frees below
                req.state = status
                req.tokens = list(committed)
                if rr is not None and rr.reason is not None:
                    req.fail_reason = rr.reason
                req.slot = None
                self.recovered[rid] = RequestHandle(req)
                continue
            # in flight at the crash
            req.suppress_until = max(req.suppress_until, len(committed))
            self._replayed_requests += 1
            self._class_stats[req.klass]["submitted"] += 1
            if (d is not None and d["state"] == RUNNING
                    and d.get("slot") is not None):
                slot = int(d["slot"])
                req.state = RUNNING
                req.slot = slot
                req.started_at = now
                self.scheduler._slots[slot] = req
                resumed.add(slot)
            else:
                # queued at the snapshot, submitted after it, or preempted
                # (slot snapshots are not persisted): prefill anew, the
                # committed prefix regenerated and suppressed
                req.state = QUEUED
                req.slot = None
                req.tokens = []
                req.hit_eos = False
                req.snapshot = None
                req.not_before = 0.0
                self.scheduler._queues[req.klass].append(req)
                self._resubmitted += 1
            self.handles[rid] = RequestHandle(req)
        # slots the snapshot had occupied but nothing resumed in: free the
        # device row (and its page tables) before the first refill
        for slot in sorted(occupied - resumed):
            self._pending_deactivate.add(slot)
            if self.kv is not None:
                self.kv.release(slot)
        self._restore_s = time.perf_counter() - t0

    def _run_chunk(self):
        """Dispatch one chunk; (toks, emit, busy, event) with a CUDA event
        recorded after the chunk on the card (None on the CPU)."""
        had_graph = "step_graph" in self.state
        self.state, toks, emit, busy, _ = self._chunk_fn(self.params,
                                                         self.state)
        self.captures += "step_graph" in self.state and not had_graph
        done = None
        if toks.is_cuda:
            done = torch.cuda.Event()
            done.record()
        return toks, emit, busy, done

    def poll(self, timeout_s: float | None = None
             ) -> list[tuple[RequestHandle, np.ndarray, bool]]:
        """Advance the session by one chunk. Returns the chunk's events:
        `(handle, new_tokens, done)` per request that emitted or finished
        (failed and shed requests surface as `(handle, empty, True)`). A
        no-op (empty list) when no request is queued or running.

        `timeout_s` (or the session's ``watchdog_s``) bounds the device
        wait: past it `SessionWedged` is raised, and the session refuses
        further polls until `recover_wedged()`.

        The order is the reference's: bit flips, admission, corruption,
        dispatch, kills, the NaN scan, harvest (with `suppress_until`),
        the scrub, the journal commit, the snapshot, the crash."""
        if self._wedged:
            raise RuntimeError("session is wedged; call recover_wedged() "
                               "before polling again")
        # scripted silent corruption lands before admission, so that the
        # admission-time checksum verify must catch it before the page is
        # shared with a new request
        if self._faults is not None:
            for page in self._faults.bit_flips(self._chunk_index):
                self._inject_bit_flip(page)
        events, self._pending_events = self._pending_events, []
        self._admit_and_refill(events)
        if self.scheduler.running == 0:
            self._handle_idle_queue(events)
            if self.scheduler.running == 0:
                return events
        chunk_idx = self._chunk_index
        timeout = timeout_s if timeout_s is not None else self.watchdog_s
        if (timeout is None and self._faults is not None
                and self._faults.pending_wedge):
            raise RuntimeError("a wedge fault is scripted but nothing "
                               "bounds the device wait: set watchdog_s "
                               "or pass poll(timeout_s=...)")
        if self._faults is not None:
            corrupted = self._faults.corrupts(chunk_idx)
            if corrupted:
                mask = np.zeros(self.n_slots, bool)
                mask[corrupted] = True
                self._fault_fn("corrupt_fn")(self.state, mask)
        t0 = self.clock.dispatch()
        toks, emit, busy, done = self._run_chunk()
        self._chunk_index += 1
        wedge = self._faults is not None and self._faults.wedged(chunk_idx)
        if timeout is None:
            self.clock.sync(toks, emit, busy)
        else:
            self._watchdog_wait(done, timeout, chunk_idx, wedge)
        dt = time.perf_counter() - t0
        toks = toks.cpu().numpy().astype(np.int32)
        emit = emit.cpu().numpy()
        busy = busy.cpu().numpy()
        now = time.perf_counter()
        self.chunk_latencies.append((dt, int(busy.max(initial=0))))
        self._total_steps += self.chunk
        self._busy_steps += int(busy.sum())
        # fault detection runs before harvest, so a dead slot's tokens are
        # never surfaced: detection frees the slot and requeues its work
        if self._faults is not None:
            for slot in self._faults.kills(chunk_idx):
                self._recover_slot(slot, quarantine=True, events=events)
        if self._nan_check or (self._faults is not None
                               and self._faults.has_corruption):
            flags = self._fault_fn("nan_scan_fn")(self.state).cpu().numpy()
            if flags.any():
                running = {s for s, _ in self.scheduler.running_requests()}
                for slot in np.flatnonzero(flags):
                    if int(slot) in running:
                        self._recover_slot(int(slot), quarantine=False,
                                           events=events)
        n_emitted = 0
        for slot, req in list(self.scheduler.running_requests()):
            new = toks[slot][emit[slot]]
            deliver = new
            skip = 0
            if new.size:
                if req.first_token_at is None:
                    req.first_token_at = now
                    self._ttfts.append(now - req.submitted_at)
                    self._class_stats[req.klass]["ttfts"].append(
                        now - req.submitted_at)
                base = req.emitted
                req.tokens.extend(new.tolist())
                n_emitted += new.size
                if self.eos_id is not None and np.any(new == self.eos_id):
                    req.hit_eos = True
                if req.suppress_until > base:
                    # exactly once after restore: these tokens were
                    # journal-committed (delivered) before the crash, and
                    # greedy decode just regenerated them bit for bit
                    skip = min(req.suppress_until - base, new.size)
                    self._deduped_tokens += skip
                    deliver = new[skip:]
            done = req.state == RUNNING and (req.hit_eos
                                             or req.emitted >= req.max_new)
            if done:
                req.state = DONE
                req.finished_at = now
                self._pending_release.add(slot)
                self._pending_publish.add(slot)     # clean completion:
                self._n_done += 1                   # prompt pages reusable
                lat = now - req.submitted_at
                self._latencies.append(lat)
                cs = self._class_stats[req.klass]
                cs["done"] += 1
                cs["lats"].append(lat)
                if req.deadline_s is not None and lat > req.deadline_s:
                    cs["deadline_miss"] += 1
                    self._deadline_miss += 1
            if (deliver.size or done) and req.rid in self.handles:
                handle = (self.handles.pop(req.rid) if done
                          else self.handles[req.rid])
                events.append((handle, deliver, done))
                if self._journal is not None:
                    if deliver.size:
                        self._journal.append({
                            "ev": "commit", "rid": req.rid,
                            "tokens": deliver.tolist(), "chunk": chunk_idx})
                    if done:
                        self._journal.append({
                            "ev": "finish", "rid": req.rid,
                            "status": "done", "reason": None})
        self._emitted_total += n_emitted
        self._per_chunk_emitted.append(n_emitted)
        # background integrity scrub: re-verify a bounded round-robin
        # slice of the stamped pages each chunk; a bad page is quarantined
        # and its cached chain dropped, so the prefix recomputes on next
        # use instead of spreading
        if (self.kv is not None and self._page_read_fn is not None
                and self._scrub_pages):
            cand = self.kv.scrub_candidates(self._scrub_pages)
            for page in self._verify_pages(cand):
                self.kv.quarantine_page(page)
        if self._journal is not None:
            # one commit a chunk: everything above is durable before the
            # events are handed to the caller
            self._journal.commit()
        # periodic bit-exact snapshot at the end of the poll: the harvest
        # already synced the device, and every event of this chunk is
        # committed at the same boundary
        if (self._snapshot_every and self._durable_dir is not None
                and self._chunk_index > 0
                and self._chunk_index % self._snapshot_every == 0
                and self._chunk_index != self._last_snapshot_chunk):
            self._save_snapshot()
        if self._faults is not None and self._faults.crashed(chunk_idx):
            if self._crash_hook is not None:
                self._crash_hook(chunk_idx)     # e.g. SIGKILL ourselves
            raise SessionCrashed(chunk_idx)
        return events

    @property
    def busy(self) -> bool:
        """True while any request is queued or running, or has terminal
        events the next `poll()` will surface."""
        return self.scheduler.busy or bool(self._pending_events)

    def stream(self, timeout_s: float | None = None
               ) -> Iterator[tuple[RequestHandle, np.ndarray, bool]]:
        """Yield `(handle, new_tokens, done)` events until the queue and
        every slot run dry. Submitting more work mid-stream extends it.
        `timeout_s` bounds each chunk's device wait (`SessionWedged`)."""
        while self.scheduler.busy or self._pending_events:
            yield from self.poll(timeout_s)

    def drain(self, timeout_s: float | None = None) -> dict:
        """Run until every submitted request completes; returns stats().
        `timeout_s` bounds each chunk's device wait (`SessionWedged`)."""
        for _ in self.stream(timeout_s):
            pass
        return self.stats()

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        """Session-level serving stats (the reference's keys).

        `occupancy_pct`: live slot-steps over all slot-steps; `ttft_ms` /
        `latency_ms`: per-request percentiles at chunk granularity (last
        `HISTORY` requests); `tokens_per_s`: emitted tokens over the chunk
        walls after the first (which carries warm-up and capture);
        `classes`: per-class SLO counters; `kv`: the paged pool's
        counters; `durability`: journal, snapshot, restore and integrity
        counters; `faults`: the plan's `summary()`."""
        rows = list(self.chunk_latencies)
        lat = np.asarray([dt for dt, _ in rows[1:]], np.float64)
        emitted = np.asarray(list(self._per_chunk_emitted)[1:], np.int64)
        tok_s = (float(emitted.sum() / max(lat.sum(), 1e-9))
                 if lat.size else 0.0)

        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0

        ttfts, lats = list(self._ttfts), list(self._latencies)
        total = self.n_slots * self._total_steps

        def per_class(k: str) -> dict:
            cs = self._class_stats[k]
            return {
                "submitted": cs["submitted"], "done": cs["done"],
                "cancelled": cs["cancelled"], "failed": cs["failed"],
                "shed": cs["shed"], "preempted": cs["preempted"],
                "retries": cs["retries"],
                "deadline_miss": cs["deadline_miss"],
                "ttft_ms": {"p50": pct(cs["ttfts"], 50) * 1e3,
                            "p99": pct(cs["ttfts"], 99) * 1e3},
                "latency_ms": {"p50": pct(cs["lats"], 50) * 1e3,
                               "p99": pct(cs["lats"], 99) * 1e3},
            }

        out = {
            "requests_done": self._n_done,
            "requests_cancelled": self._n_cancelled,
            "requests_failed": self._n_failed,
            "requests_shed": sum(cs["shed"]
                                 for cs in self._class_stats.values()),
            "emitted_total": self._emitted_total,
            "tokens_per_s": tok_s,
            "occupancy_pct": 100.0 * self._busy_steps / max(total, 1),
            "ttft_ms": {"p50": pct(ttfts, 50) * 1e3,
                        "p99": pct(ttfts, 99) * 1e3},
            "latency_ms": {"p50": pct(lats, 50) * 1e3,
                           "p99": pct(lats, 99) * 1e3},
            "preemptions": self._n_preemptions,
            "retries": self._n_retries,
            "deadline_miss": self._deadline_miss,
            "classes": {k: per_class(k) for k in CLASSES},
            "quarantined_slots": self.scheduler.quarantined,
            "usable_slots": self.scheduler.usable_slots,
            "queue_peak": self.scheduler.queue_peak,
            "admitted_order": list(self.scheduler.admitted_order),
            "slots": self.n_slots,
            "chunk": self.chunk,
            "stall": self.clock.report(),
        }
        if self.kv is not None:
            out["kv"] = dict(self.kv.stats(),
                             pool_exhausted=self._n_pool_exhausted,
                             prefix_pages_expected=self._prefix_pages_expected)
        if self._durable_dir is not None or self._page_read_fn is not None:
            kv = self.kv
            out["durability"] = {
                "journal_bytes": (self._journal.bytes_written
                                  if self._journal else 0),
                "journal_events": (self._journal.seq
                                   if self._journal else 0),
                "snapshots": self._snapshots_taken,
                "snapshot_every": self._snapshot_every,
                "restored_step": self._restored_step,
                "replayed_requests": self._replayed_requests,
                "resubmitted": self._resubmitted,
                "recovered_terminal": len(self.recovered),
                "deduped_tokens": self._deduped_tokens,
                "integrity_checks": kv.integrity_checks if kv else 0,
                "integrity_violations": kv.integrity_violations if kv else 0,
                "integrity_repairs": kv.integrity_repairs if kv else 0,
                "quarantined_pages": (len(kv.pool.quarantined)
                                      if kv else 0),
                "restore_s": self._restore_s,
            }
        if self._faults is not None:
            out["faults"] = self._faults.summary()
        return out

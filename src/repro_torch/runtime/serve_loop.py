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
are both served.

Shedding, preemption, fault injection and recovery, the watchdog, the
request journal and session snapshots are ROADMAP Queue 1 item 8; the
knobs that would engage them raise NotImplementedError.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.runtime.compile_cache import Graphed, tensor_leaves
from repro_torch.runtime.engine import DecodeEngine, StallClock
from repro_torch.runtime.kvpool import PagedKV, PoolExhausted
from repro_torch.runtime.scheduler import (DONE, QUEUED, REASON_POOL,
                                           RUNNING, RequestHandle,
                                           SlotScheduler)

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


def _no_watchdog(timeout_s) -> None:
    if timeout_s is not None:
        raise NotImplementedError(
            "timeout_s bounds the device wait through the watchdog, which "
            "is ROADMAP Queue 1 item 8")


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


class ServeSession:
    """A long-lived slot pool serving a stream of independent requests::

        sess = cluster.compile(ServeSessionProgram(slots=8)).open()
        h = sess.submit(prompt, max_new=64)        # -> RequestHandle
        for handle, toks, done in sess.stream():   # incremental tokens
            ...
        sess.drain()
        h.result()                                 # (T,) np.int32
    """

    def __init__(self, chunk_fn: Callable, refill_fn: Callable, params,
                 state: dict, *, n_slots: int, chunk: int, max_prompt: int,
                 max_seq: int | None = None, eos_id: int | None = None,
                 max_queue: int | None = None, kv: PagedKV | None = None,
                 page_copy_fn: Callable | None = None):
        self._chunk_fn = chunk_fn
        self._refill_fn = refill_fn
        self.params = params
        self.state = state
        self.n_slots = n_slots
        self.chunk = chunk
        self.max_prompt = max_prompt
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.kv = kv
        self._page_copy_fn = page_copy_fn
        self.scheduler = SlotScheduler(n_slots, max_queue=max_queue)
        self.clock = StallClock()
        self.chunk_latencies: deque[tuple[float, int]] = deque(
            maxlen=HISTORY)
        self.handles: dict[int, RequestHandle] = {}    # in-flight only
        self._pending_release: set[int] = set()
        self._pending_publish: set[int] = set()
        self._pending_deactivate: set[int] = set()
        self._n_pool_exhausted = 0
        self._busy_steps = 0
        self._total_steps = 0
        self._emitted_total = 0
        self._per_chunk_emitted: deque[int] = deque(maxlen=HISTORY)
        self._ttfts: deque[float] = deque(maxlen=HISTORY)
        self._latencies: deque[float] = deque(maxlen=HISTORY)
        self._n_done = 0
        self._n_cancelled = 0
        self._n_failed = 0

    # -- request lifecycle ----------------------------------------------
    def submit(self, prompt, max_new: int, *, klass: str = "latency",
               deadline_s: float | None = None) -> RequestHandle:
        """Enqueue one request; admitted to a slot at a chunk boundary.
        Raises `scheduler.QueueFull` when the queue is at capacity."""
        if deadline_s is not None:
            raise NotImplementedError("deadlines belong to the SLO layer "
                                      "(ROADMAP Queue 1 item 8)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size > self.max_prompt:
            raise ValueError(f"prompt of {prompt.size} tokens exceeds the "
                             f"session's max_prompt={self.max_prompt}")
        # the last KV write lands at position P + max_new - 2
        if (self.max_seq is not None
                and prompt.size + max_new - 1 > self.max_seq):
            raise ValueError(f"prompt ({prompt.size}) + max_new ({max_new}) "
                             f"exceeds the session's max_seq={self.max_seq}")
        req = self.scheduler.submit(prompt, max_new, klass=klass)
        handle = RequestHandle(req)
        self.handles[req.rid] = handle
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Queued: removed now. Running: its slot is freed at the next
        chunk boundary."""
        was_queued = handle.state == QUEUED
        ok = self.scheduler.cancel(handle._req)
        if ok:
            self._n_cancelled += 1
            if was_queued:
                self.handles.pop(handle.id, None)
        return ok

    # -- the chunk boundary ---------------------------------------------
    def _fail_request(self, req, reason: str, events: list) -> None:
        self.scheduler.fail(req, reason)
        self._n_failed += 1
        handle = self.handles.pop(req.rid, None)
        if handle is not None:
            events.append((handle, np.empty(0, np.int32), True))

    def _alloc_pages(self, fresh: list, events: list) -> list:
        """Paged admission: build each fresh slot's page table. A request
        the pool cannot cover now is requeued (pages free as slots
        retire); when the pool is idle and empty and it still does not
        fit, it fails with the typed reason "pool_exhausted"."""
        kept: list = []
        for slot, req in fresh:
            try:
                alloc = self.kv.admit(slot, req.prompt, req.max_new)
            except PoolExhausted:
                self._n_pool_exhausted += 1
                self.scheduler.release(slot)
                if (not kept and self.scheduler.running == 0
                        and self.kv.pool.used_pages == 0):
                    self._fail_request(req, REASON_POOL, events)
                else:
                    self.scheduler.requeue(req)
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
                    self.kv.publish(slot)       # seed the prefix cache
                self.kv.release(slot)
        self._pending_release.clear()
        self._pending_publish.clear()
        admits = self.scheduler.admit()
        if not admits and not self._pending_deactivate:
            return
        release = np.zeros(self.n_slots, bool)
        if self._pending_deactivate:
            release[sorted(self._pending_deactivate)] = True
        fresh = admits
        kv_fresh = []
        if self.kv is not None and fresh:
            kv_fresh = self._alloc_pages(fresh, events)
            fresh = [(s, r) for s, r, _ in kv_fresh]
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
                self.state = self._refill_fn(self.state, admit, release,
                                             pbuf, plen, budget, pages,
                                             start)
                if cow_src:     # COW fork: copy before the next chunk
                    self.state = self._page_copy_fn(
                        self.state, np.asarray(cow_src, np.int32),
                        np.asarray(cow_dst, np.int32))
            else:
                self.state = self._refill_fn(self.state, admit, release,
                                             pbuf, plen, budget)
        self._pending_deactivate.clear()

    def poll(self, timeout_s: float | None = None
             ) -> list[tuple[RequestHandle, np.ndarray, bool]]:
        """Advance the session by one chunk. Returns the chunk's events,
        `(handle, new_tokens, done)` per request that emitted or finished.
        A no-op (empty list) when no request is queued or running.
        `timeout_s` (the watchdog's bound on the device wait) is ROADMAP
        Queue 1 item 8: any value but None raises."""
        _no_watchdog(timeout_s)
        events: list = []
        self._admit_and_refill(events)
        if self.scheduler.running == 0 and self.scheduler.queued:
            self._admit_and_refill(events)
        if self.scheduler.running == 0:
            return events
        t0 = self.clock.dispatch()
        self.state, toks, emit, busy, _ = self._chunk_fn(self.params,
                                                         self.state)
        self.clock.sync(toks, emit, busy)
        dt = time.perf_counter() - t0
        toks = toks.cpu().numpy().astype(np.int32)
        emit = emit.cpu().numpy()
        busy = busy.cpu().numpy()
        now = time.perf_counter()
        self.chunk_latencies.append((dt, int(busy.max(initial=0))))
        self._total_steps += self.chunk
        self._busy_steps += int(busy.sum())
        n_emitted = 0
        for slot, req in list(self.scheduler.running_requests()):
            new = toks[slot][emit[slot]]
            if new.size:
                if req.first_token_at is None:
                    req.first_token_at = now
                    self._ttfts.append(now - req.submitted_at)
                req.tokens.extend(new.tolist())
                n_emitted += new.size
                if self.eos_id is not None and np.any(new == self.eos_id):
                    req.hit_eos = True
            done = req.state == RUNNING and (req.hit_eos
                                             or req.emitted >= req.max_new)
            if done:
                req.state = DONE
                req.finished_at = now
                self._pending_release.add(slot)
                self._pending_publish.add(slot)
                self._n_done += 1
                self._latencies.append(now - req.submitted_at)
            if (new.size or done) and req.rid in self.handles:
                handle = (self.handles.pop(req.rid) if done
                          else self.handles[req.rid])
                events.append((handle, new, done))
        self._emitted_total += n_emitted
        self._per_chunk_emitted.append(n_emitted)
        return events

    @property
    def busy(self) -> bool:
        return self.scheduler.busy

    def stream(self, timeout_s: float | None = None
               ) -> Iterator[tuple[RequestHandle, np.ndarray, bool]]:
        """Yield `(handle, new_tokens, done)` events until the queue and
        every slot run dry. Submitting more work mid-stream extends it.
        `timeout_s` as in `poll`."""
        _no_watchdog(timeout_s)
        while self.scheduler.busy:
            yield from self.poll()

    def drain(self, timeout_s: float | None = None) -> dict:
        """Run until every submitted request completes; returns stats().
        `timeout_s` as in `poll`."""
        _no_watchdog(timeout_s)
        for _ in self.stream():
            pass
        return self.stats()

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        """`occupancy_pct`: live slot-steps over all slot-steps;
        `tokens_per_s`: emitted tokens over the chunk walls after the first
        (which carries warm-up); `ttft_ms` / `latency_ms`: per-request
        percentiles at chunk granularity; `kv`: the paged pool's
        counters."""
        rows = list(self.chunk_latencies)
        lat = np.asarray([dt for dt, _ in rows[1:]], np.float64)
        emitted = np.asarray(list(self._per_chunk_emitted)[1:], np.int64)
        tok_s = (float(emitted.sum() / max(lat.sum(), 1e-9))
                 if lat.size else 0.0)

        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0

        ttfts, lats = list(self._ttfts), list(self._latencies)
        out = {
            "requests_done": self._n_done,
            "requests_cancelled": self._n_cancelled,
            "requests_failed": self._n_failed,
            "emitted_total": self._emitted_total,
            "tokens_per_s": tok_s,
            "occupancy_pct": 100.0 * self._busy_steps / max(
                self.n_slots * self._total_steps, 1),
            "ttft_ms": {"p50": pct(ttfts, 50) * 1e3,
                        "p99": pct(ttfts, 99) * 1e3},
            "latency_ms": {"p50": pct(lats, 50) * 1e3,
                           "p99": pct(lats, 99) * 1e3},
            "queue_peak": self.scheduler.queue_peak,
            "admitted_order": list(self.scheduler.admitted_order),
            "slots": self.n_slots,
            "chunk": self.chunk,
            "stall": self.clock.report(),
        }
        if self.kv is not None:
            out["kv"] = dict(self.kv.stats(),
                             pool_exhausted=self._n_pool_exhausted)
        return out

"""Execution engine (the port of `repro.runtime.engine`): the K-step
decode of a fixed batch (`DecodeEngine`), the session cell of
continuous batching (`session_chunk_fn`) and the K-step train chunk
(`make_train_chunk`).

The reference compiles K decode steps into one `lax.scan` program with
its buffers donated through it. On the CPU the port runs the K steps as a
Python loop over the same tensors, updated in place where the reference
donates them. On the card it captures one step once as a CUDA graph
(`compile_cache.Captured`) and replays it: what the reference gets from
compiling the scan. Either way the host syncs once per K tokens.

`DecodeEngine` captures one step of the chunk as a graph, per scan length
K (the steady chunk and a shorter tail), over tensors it keeps: the last
token (B, 1), the per-slot `finished` and `emitted`, the position `pos`
(a 0-d tensor, advanced on the card), `remaining`, the step index, the
step count and the (B, K) token block, and the caller's cache. A chunk
is K replays of that graph, back to back. (One graph of all K steps was
the other design: `tools/engine_chunk_graphs.py` times both; PERF.md.)

The reference skips the model body with `lax.cond` on each step at which
every slot is done; a graph has no device-side skip (that needs CUDA-graph
conditional nodes, which the port does not build). So the engine's steps
after every slot hit EOS inside a chunk still run the model. They change
no returned token, `emitted`, `finished`, `pos` or the step count `n`,
and may write the cache row at the frozen `pos`: tokens, `emitted`,
`finished` and cache rows [0, pos) equal the reference's bit for bit,
rows at and past `pos` may differ, and no later step reads them before it
overwrites them (decode writes its row before it attends). The session
instead bounds the chunk at its start: it runs the steps the slowest live
slot still needs (its remaining prompt plus its remaining budget) and
none once every slot is done; a chunk in which EOS ends every slot early
still runs its remaining steps, which emit nothing and change no slot's
tokens, position or counters, exactly as skipped steps do. On the GPU one
session step is captured and replayed: the step's ~1,800 launches from
Python become one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.compile_cache import (Captured, Graphed,
                                               tensor_leaves)

I64 = torch.int64


@dataclasses.dataclass
class StallClock:
    """Host-side stall ledger for a device-resident loop: host syncs,
    dispatch-gap time (host-only work between one sync and the next
    dispatch, the device idle) and device-wait time."""

    host_syncs: int = 0
    dispatch_gap_s: float = 0.0
    device_wait_s: float = 0.0
    _t_start: float = dataclasses.field(default_factory=time.perf_counter)
    _last_sync_end: float | None = None

    def dispatch(self) -> float:
        now = time.perf_counter()
        if self._last_sync_end is not None:
            self.dispatch_gap_s += now - self._last_sync_end
        return now

    def sync(self, *tensors) -> float:
        """Block until the device finished the work behind `tensors`."""
        t0 = time.perf_counter()
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
                break
        now = time.perf_counter()
        self.host_syncs += 1
        self.device_wait_s += now - t0
        self._last_sync_end = now
        return now

    def sync_done(self, t_wait_start: float) -> float:
        """Record a sync whose device wait happened elsewhere (the
        session's watchdog polls an event): the wait ran from
        `t_wait_start` to now."""
        now = time.perf_counter()
        self.host_syncs += 1
        self.device_wait_s += now - t_wait_start
        self._last_sync_end = now
        return now

    def report(self) -> dict:
        wall = time.perf_counter() - self._t_start
        return {
            "host_syncs": self.host_syncs,
            "dispatch_gap_s": self.dispatch_gap_s,
            "device_wait_s": self.device_wait_s,
            "wall_s": wall,
            "stall_pct": 100.0 * self.dispatch_gap_s / max(wall, 1e-12),
        }


# ----------------------------------------------------------------------------
# K-step decode of a fixed batch
# ----------------------------------------------------------------------------

def _chunk_step(decode_step: Callable, eos_id: int | None) -> Callable:
    """One step of the K-step decode program, in place on the state `s`
    (tok, finished, emitted, pos, remaining; the chunk's step index `t`,
    its step count `n` and its (B, K) token block `toks`). No host read,
    so that the step can be captured as a CUDA graph."""

    def step(params, cache, s):
        tok, finished = s["tok"], s["finished"]
        stop = s["remaining"] <= s["t"]
        if eos_id is not None:
            stop = stop | torch.all(finished)
        active = ~stop
        _, raw = decode_step(params, cache, {"tokens": tok, "pos": s["pos"]})
        raw = torch.where(active, raw.to(tok.dtype), tok)
        if eos_id is not None:
            # finished slots (and stop steps) hold EOS regardless of the
            # argmax: the host loop's masking order
            out = torch.where((finished | stop)[:, None], eos_id, raw)
            new_finished = torch.where(
                active, finished | (out[:, 0] == eos_id), finished)
        else:
            out, new_finished = raw, finished
        s["emitted"].add_((active & ~finished).to(s["emitted"].dtype))
        finished.copy_(new_finished)
        tok.copy_(out)
        s["pos"].add_(active.to(s["pos"].dtype))
        s["n"].add_(active.to(I64))
        s["toks"].index_copy_(1, s["t"].view(1), out)
        s["t"].add_(1)

    return step


def _chunk_state(tok, width: int) -> dict:
    """A chunk's own tensors: step index, step count, (B, width) tokens."""
    return {"t": torch.zeros((), dtype=I64, device=tok.device),
            "n": torch.zeros((), dtype=I64, device=tok.device),
            "toks": torch.zeros((tok.shape[0], width), dtype=tok.dtype,
                                device=tok.device)}


def decode_chunk_fn(decode_step: Callable, chunk: int,
                    eos_id: int | None = None) -> Callable:
    """The K-step decode program, eager (see `make_decode_chunk`)::

        chunk_fn(params, cache, tok, finished, emitted, pos, remaining)
          -> (cache, tok, finished, emitted, pos, n_steps, all_done, tokens)

    `tok` (B, 1) is the last sampled token, `finished` / `emitted` the
    per-slot EOS flags and emitted-token counters, `pos` the decode
    position and `remaining` how many tokens the caller still wants (both
    0-d tensors). `cache`, `tok`, `finished`, `emitted` and `pos` are
    updated in place (what the reference donates) and returned; `n_steps`,
    `all_done` (0-d) and `tokens` (B, K) are new. Only the first `n_steps`
    columns of `tokens` are valid. Nothing reads the device from the host.
    (A `DecodeChunk` whose steps all run eagerly.)

    Step semantics replicate the per-token host loop bit for bit:
    `emitted` counts a slot's tokens up to and including its EOS; a
    finished slot's tokens are masked to EOS before being fed back and
    recorded. A step past `remaining`, or after every slot finished, is a
    stop step: it runs the model (see the module docstring), its column
    holds EOS (or the last token) and nothing else moves."""
    return DecodeChunk(decode_step, chunk, eos_id=eos_id, cuda_graph=False)


class DecodeChunk:
    """The K-step decode program of `make_decode_chunk`, with
    `decode_chunk_fn`'s calling convention and results.

    Its step is `Graphed`: on the card the first step runs eagerly and is
    captured (over the program's own step index, count and token block and
    the caller's in-place tensors), and every later step replays that one
    graph, K replays a chunk back to back with no host read between.
    `tools/engine_chunk_graphs.py` times this against one graph of all K
    steps. The in-place arguments must be the same tensors from call to
    call, as the reference's donated buffers are threaded forward: other
    tensors capture anew. On CPU tensors, or with ``cuda_graph=False``,
    every step runs eagerly."""

    def __init__(self, decode_step: Callable, chunk: int, *,
                 eos_id: int | None = None, cuda_graph: bool = True):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = chunk
        self.eos_id = eos_id
        self.step = Graphed(_chunk_step(getattr(decode_step, "eager",
                                                decode_step), eos_id),
                            cuda_graph=cuda_graph)
        self._own: dict | None = None

    @property
    def graphs(self):
        """The step's captured graphs (a `CompileCache`)."""
        return self.step.graphs

    @torch.inference_mode()
    def __call__(self, params, cache, tok, finished, emitted, pos,
                 remaining):
        own = self._own
        if (own is None or own["toks"].shape[0] != tok.shape[0]
                or own["toks"].device != tok.device
                or own["toks"].dtype != tok.dtype):
            own = self._own = _chunk_state(tok, self.chunk)
        own["t"].zero_()
        own["n"].zero_()
        s = dict(own, tok=tok, finished=finished, emitted=emitted, pos=pos,
                 remaining=remaining)
        for _ in range(self.chunk):
            self.step(params, cache, s)
        all_done = (torch.all(finished) if self.eos_id is not None
                    else torch.zeros((), dtype=torch.bool, device=tok.device))
        return (cache, tok, finished, emitted, pos, own["n"].clone(),
                all_done, own["toks"].clone())


def make_decode_chunk(decode_step: Callable, chunk: int, *,
                      eos_id: int | None = None,
                      cuda_graph: bool = True) -> DecodeChunk:
    """The K-step decode program: `decode_chunk_fn`'s K steps with one CUDA
    graph of a step replayed K times on the card (`DecodeChunk`).
    `cuda_graph=False` runs every step eagerly (to check the graph
    against)."""
    return DecodeChunk(decode_step, chunk, eos_id=eos_id,
                       cuda_graph=cuda_graph)


class DecodeEngine:
    """Drives the K-step decode program chunk by chunk.

    One `generate` produces up to `max_new` tokens with `ceil(T / K)` host
    syncs instead of `T`. Per-chunk wall times land in `chunk_latencies`
    as `(seconds, steps)` pairs and the stall ledger in `clock`. The
    engine keeps the chunk's token, flag, counter and position tensors
    (one set per batch size and device), so on the card each chunk length
    (the steady chunk K and a tail chunk of `max_new % K` steps) captures
    its step graph once, and every later chunk replays it. The cache is
    the caller's, used in place; pass the same cache tensors to every
    `generate` (zeroed between generations) to replay the same graphs. A
    `Graphed` decode step is unwrapped: the chunk captures its eager
    kernels itself."""

    def __init__(self, decode_step: Callable, chunk: int = 16, *,
                 eos_id: int | None = None, cuda_graph: bool = True):
        self.chunk = chunk
        self.eos_id = eos_id
        self.cuda_graph = cuda_graph
        self._decode_step = decode_step
        # programs keyed by scan length: the steady chunk is K; a tail
        # chunk (max_new % K) gets a short variant, built once and reused
        self._chunk_fns: dict[int, DecodeChunk] = {
            chunk: make_decode_chunk(decode_step, chunk, eos_id=eos_id,
                                     cuda_graph=cuda_graph)}
        self._state: dict | None = None
        self.clock = StallClock()
        self.chunk_latencies: list[tuple[float, int]] = []

    def _fn_for(self, k: int) -> DecodeChunk:
        fn = self._chunk_fns.get(k)
        if fn is None:
            fn = make_decode_chunk(self._decode_step, k, eos_id=self.eos_id,
                                   cuda_graph=self.cuda_graph)
            self._chunk_fns[k] = fn
        return fn

    def _static(self, b: int, device: torch.device) -> dict:
        s = self._state
        if s is None or s["tok"].shape[0] != b or s["tok"].device != device:
            with torch.inference_mode():
                s = self._state = {
                    "tok": torch.zeros((b, 1), dtype=I64, device=device),
                    "finished": torch.zeros(b, dtype=torch.bool,
                                            device=device),
                    "emitted": torch.zeros(b, dtype=I64, device=device),
                    "pos": torch.zeros((), dtype=I64, device=device),
                    "remaining": torch.zeros((), dtype=I64, device=device)}
        return s

    def generate(self, params, cache, start_tok: np.ndarray, max_new: int,
                 start_pos: int = 0):
        """Returns (out (B, 1 + T) np.int32, cache, finished, emitted).

        `out[:, 0]` is the start token; T <= max_new generation columns
        follow (shorter when every slot hits EOS early). `cache` is the
        caller's cache, updated in place."""
        start_tok = np.asarray(start_tok)
        B = start_tok.shape[0]
        out = np.empty((B, 1 + max_new), np.int32)       # one host buffer
        out[:, 0] = start_tok[:, 0]
        dev = next(tensor_leaves(cache)).device
        s = self._static(B, dev)
        with torch.inference_mode():
            s["tok"].copy_(torch.as_tensor(start_tok.astype(np.int64)))
            s["finished"].zero_()
            s["emitted"].zero_()
            s["pos"].fill_(start_pos)
        self.clock = StallClock()
        self.chunk_latencies = []
        w = 0
        while w < max_new:
            remaining = max_new - w
            k = min(self.chunk, remaining)      # tail chunk: short variant
            t0 = self.clock.dispatch()
            with torch.inference_mode():
                s["remaining"].fill_(remaining)
            (cache, _, _, _, _, n, all_done, toks) = self._fn_for(k)(
                params, cache, s["tok"], s["finished"], s["emitted"],
                s["pos"], s["remaining"])
            self.clock.sync(n, all_done, toks)
            dt = time.perf_counter() - t0
            n, all_done = int(n), bool(all_done)
            self.chunk_latencies.append((dt, n))
            out[:, 1 + w:1 + w + n] = toks[:, :n].cpu().numpy()
            w += n
            if n < k or all_done:
                break
        return (out[:, :1 + w], cache, s["finished"].cpu().numpy(),
                s["emitted"].cpu().numpy().astype(np.int64))


# ----------------------------------------------------------------------------
# The continuous-batching session cell
# ----------------------------------------------------------------------------

def init_session_state(cache, n_slots: int, max_prompt: int,
                       pages_per_slot: int | None = None, *,
                       device=None) -> dict:
    """Fresh device state for a ServeSession's slot pool (all slots idle)
    on `device` (None: the GPU). `pages_per_slot` (paged sessions) adds the
    per-slot page tables, every entry at the reserved trash page 0."""
    device = resolve_device(device)

    def ints(*shape):
        return torch.zeros(shape, dtype=I64, device=device)

    state = {
        "cache": cache,
        "tok": ints(n_slots, 1),               # last sampled token per slot
        "pos": ints(n_slots),                  # per-slot decode position
        "consumed": ints(n_slots),             # prompt tokens consumed
        "prompt_len": ints(n_slots),
        "prompt_buf": ints(n_slots, max_prompt),
        "budget": ints(n_slots),               # max_new per slot
        "emitted": ints(n_slots),
        "finished": torch.zeros(n_slots, dtype=torch.bool, device=device),
        "active": torch.zeros(n_slots, dtype=torch.bool, device=device),
        "age": ints(n_slots),                  # admissions seen by the slot
    }
    if pages_per_slot is not None:
        state["pages"] = ints(n_slots, pages_per_slot)
    return state


def _done(s):
    return (~s["active"]) | s["finished"] | (s["emitted"] >= s["budget"])


def steps_needed(state) -> int:
    """Decode steps until every slot is done, barring EOS: a live slot
    still feeds max(prompt_len - consumed - 1, 0) prompt tokens before its
    first emission, then emits budget - emitted tokens. One host read."""
    rows = torch.stack([state["consumed"], state["prompt_len"],
                        state["emitted"], state["budget"],
                        _done(state).to(I64)]).cpu().numpy()
    consumed, plen, emitted, budget, done = rows
    need = (np.maximum(plen - consumed - 1, 0) + (budget - emitted))
    need = need[done == 0]
    return int(need.max()) if need.size else 0


def _session_step(decode_step, params, s, eos_id):
    """One decode step of every slot, updating the session state `s` in
    place. Returns this step's (raw token (B,), emitted (B,), live (B,))."""
    p_max = s["prompt_buf"].shape[1]
    done = _done(s)
    live = ~done
    fed_prompt = live & (s["consumed"] < s["prompt_len"])
    idx = torch.clamp(s["consumed"], 0, p_max - 1)
    p_tok = torch.gather(s["prompt_buf"], 1, idx[:, None])
    in_tok = torch.where(fed_prompt[:, None], p_tok, s["tok"])
    batch = {"tokens": in_tok, "pos": s["pos"]}
    if "pages" in s:
        batch["pages"] = s["pages"]
    _, raw = decode_step(params, s["cache"], batch)
    raw = raw.to(I64)
    consumed = s["consumed"] + fed_prompt
    em = live & (consumed >= s["prompt_len"])
    if eos_id is not None:
        s["finished"].copy_(s["finished"] | (em & (raw[:, 0] == eos_id)))
    s["tok"].copy_(torch.where(done[:, None], s["tok"], raw))
    s["pos"].add_(live)
    s["consumed"].copy_(consumed)
    s["emitted"].add_(em)
    return raw[:, 0], em, live


def session_chunk_fn(decode_step: Callable, chunk: int,
                     eos_id: int | None = None, *,
                     cuda_graph: bool = True) -> Callable:
    """The K-step session program: `chunk_fn(params, state) -> (state,
    tokens (B, K), emit (B, K) bool, busy (B,), all_done)`.

    Every slot advances through its own request: while `consumed <
    prompt_len` the step feeds the next prompt token (outputs discarded
    until the step that consumes the last prompt token, whose output is
    the first emitted token); afterwards it feeds back its own sampled
    token. Slots are done — frozen, position not advancing — once
    inactive, finished (EOS) or out of budget. `busy` counts the steps
    each slot was live for; `all_done` is a 0-d bool tensor.

    On CUDA state the session's step is captured as a CUDA graph at its
    first step (a `Captured`, kept in ``state["step_graph"]``; the first
    step is its warm-up) and replayed for every later step: the same
    kernels on the same tensors, so the same results.
    `cuda_graph=False` runs every step eagerly (to check the graph
    against)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    @torch.inference_mode()
    def chunk_fn(params, state):
        b = state["prompt_buf"].shape[0]
        dev = state["tok"].device
        graphed = cuda_graph and dev.type == "cuda"
        toks = torch.zeros((b, chunk), dtype=I64, device=dev)
        emit = torch.zeros((b, chunk), dtype=torch.bool, device=dev)
        busy = torch.zeros(b, dtype=I64, device=dev)
        for t in range(min(chunk, steps_needed(state))):
            if not graphed:
                raw, em, live = _session_step(decode_step, params, state,
                                              eos_id)
            elif "step_graph" not in state:
                state["step_graph"] = Captured(lambda: _session_step(
                    decode_step, params, state, eos_id))
                raw, em, live = state["step_graph"].first
            else:
                raw, em, live = state["step_graph"].replay()
            toks[:, t] = raw
            emit[:, t] = em
            busy += live
        return state, toks, emit, busy, torch.all(_done(state))

    return chunk_fn


def make_session_refill(*, cache_zero: Callable) -> Callable:
    """`refill(state, admit, release, prompt_buf, prompt_len, budget) ->
    state`, in place. `admit`/`release` are (B,) bool host masks; admitted
    slots get their cache rows zeroed (`cache_zero`), counters reset, the
    new prompt row and budget installed and `age` bumped; released slots
    go inactive. Rows outside `admit` are ignored."""

    @torch.inference_mode()
    def refill(state, admit, release, prompt_buf, prompt_len, budget):
        return _refill(state, admit, release, prompt_buf, prompt_len,
                       budget, cache_zero, start=None, pages=None)

    return refill


def make_paged_session_refill(*, cache_zero: Callable) -> Callable:
    """The paged refill: `refill(state, admit, release, prompt_buf,
    prompt_len, budget, pages, start) -> state`. `pages` installs each
    admitted slot's page-table row; released slots' rows are re-pointed
    at the trash page 0; `start` is the admitted slot's first position
    (non-zero exactly when shared prefix pages cover the first `start`
    prompt tokens — the prefill skip). `cache_zero` zeroes private leaves
    only; pool pages are left as they are."""

    @torch.inference_mode()
    def refill(state, admit, release, prompt_buf, prompt_len, budget,
               pages, start):
        return _refill(state, admit, release, prompt_buf, prompt_len,
                       budget, cache_zero, start=start, pages=pages)

    return refill


def _refill(state, admit, release, prompt_buf, prompt_len, budget,
            cache_zero, *, start, pages):
    """In place: the session's tensors keep their storage (a captured CUDA
    graph of the session step reads and writes them)."""
    dev = state["tok"].device

    def dt(a, dtype=I64):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    admit_t = dt(admit, torch.bool)
    release_t = dt(release, torch.bool)
    col = admit_t[:, None]
    start_t = dt(start) if start is not None else torch.zeros_like(
        state["pos"])
    cache_zero(state["cache"], admit_t)

    def put(key, value):
        state[key].copy_(value)

    put("tok", torch.where(col, 0, state["tok"]))
    put("pos", torch.where(admit_t, start_t, state["pos"]))
    put("consumed", torch.where(admit_t, start_t, state["consumed"]))
    put("emitted", torch.where(admit_t, 0, state["emitted"]))
    put("finished", torch.where(admit_t, False, state["finished"]))
    put("active", (state["active"] & ~release_t) | admit_t)
    put("age", state["age"] + admit_t)
    put("prompt_buf", torch.where(col, dt(prompt_buf), state["prompt_buf"]))
    put("prompt_len", torch.where(admit_t, dt(prompt_len),
                                  state["prompt_len"]))
    put("budget", torch.where(admit_t, dt(budget), state["budget"]))
    if pages is not None:
        put("pages", torch.where(
            col, dt(pages),
            torch.where(release_t[:, None], 0, state["pages"])))
    return state


def make_page_copy(cache_copy: Callable) -> Callable:
    """Pool page copy, the COW fork's device half: `page_copy(state, src,
    dst) -> state` (equal-length page-id vectors), in place."""

    @torch.inference_mode()
    def page_copy(state, src, dst):
        cache_copy(state["cache"], np.asarray(src), np.asarray(dst))
        return state

    return page_copy


def make_page_scrub(cache_scrub: Callable) -> Callable:
    """Pool page scrub: `page_scrub(state, pages) -> state`, in place."""

    @torch.inference_mode()
    def page_scrub(state, pages):
        cache_scrub(state["cache"], np.asarray(pages))
        return state

    return page_scrub


def _as_index(a, device, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def make_paged_nan_scan(cache_nan: Callable) -> Callable:
    """Paged corruption sentinel: `nan_scan(state) -> (B,) bool` tensor.
    `cache_nan(cache, tables)` is `make_paged_cache_ops["nan_slots"]`:
    pool leaves are attributed to slots through the page tables."""

    @torch.inference_mode()
    def nan_scan(state):
        return cache_nan(state["cache"], state["pages"])

    return nan_scan


def make_paged_slot_corrupt(cache_corrupt: Callable) -> Callable:
    """Paged fault injection: `corrupt(state, mask) -> state`, in place,
    NaNs the masked slots' private rows and their table-addressed pool
    pages (`make_paged_cache_ops["corrupt_slots"]`)."""

    @torch.inference_mode()
    def corrupt(state, mask):
        cache_corrupt(state["cache"], _as_index(mask, state["tok"].device,
                                                torch.bool), state["pages"])
        return state

    return corrupt


def make_page_read(cache_read: Callable) -> Callable:
    """Pool page readback for the integrity checksums: `page_read(state,
    pages) -> tuple` of host numpy arrays, one a pool leaf, page axis
    first, holding the pages' raw bytes (bf16 has no numpy type)."""

    @torch.inference_mode()
    def page_read(state, pages):
        return tuple(t.contiguous().view(torch.uint8).cpu().numpy()
                     for t in cache_read(state["cache"], pages))

    return page_read


def make_page_flip(cache_flip: Callable) -> Callable:
    """Silent page corruption for the `bit_flip` fault: `page_flip(state,
    pages) -> state` adds 1 to the pages' float content in place: finite
    values the NaN scan cannot see, so only the checksum catches them."""

    @torch.inference_mode()
    def page_flip(state, pages):
        cache_flip(state["cache"], pages)
        return state

    return page_flip


# ----------------------------------------------------------------------------
# Slot-granular checkpoint/resume + fault detection
# ----------------------------------------------------------------------------
#
# A slot must be individually checkpointable (preemption snapshots its
# cache rows and decode counters and requeues the request for a
# bit-identical resume) and individually condemnable (a dead or corrupted
# slot is quarantined and the pool degrades instead of crashing). These
# are the device half; `ServeSession` drives them. Every write is in
# place: a captured session step replays on the addresses it captured.
#
# The per-request device rows that travel with a slot snapshot. `active`
# and `age` are slot properties: restore sets active and bumps age like
# any other admission.
SLOT_FIELDS = ("tok", "pos", "consumed", "prompt_len", "prompt_buf",
               "budget", "emitted", "finished")


def make_slot_snapshot(*, cache_take: Callable) -> Callable:
    """The slot checkpoint: `snapshot(state, slot) -> rows`, a copy on the
    state's device of slot `slot`'s cache rows (`cache_take`, e.g.
    `steps.take_cache_slot`) and every `SLOT_FIELDS` entry. The pool
    state is left as it is."""

    @torch.inference_mode()
    def snapshot(state, slot):
        slot = int(slot)
        # the cache rows first: their copy runs while the host dispatches
        # the small fields
        rows = {"cache": cache_take(state["cache"], slot)}
        rows.update((k, state[k][slot].clone()) for k in SLOT_FIELDS)
        return rows

    return snapshot


def make_slot_restore(*, cache_put: Callable) -> Callable:
    """The slot resume: `restore(state, slot, rows) -> state` writes a
    snapshot's rows back into slot `slot` in place and bit for bit
    (`cache_put`, e.g. `steps.put_cache_slot`), marks the slot active
    and bumps its `age` (a resume is an admission)."""

    @torch.inference_mode()
    def restore(state, slot, rows):
        slot = int(slot)
        cache_put(state["cache"], slot, rows["cache"])
        for k in SLOT_FIELDS:
            state[k][slot].copy_(rows[k])
        state["active"][slot].fill_(True)
        state["age"][slot].add_(1)
        return state

    return restore


def make_nan_scan(*, cache_nan: Callable) -> Callable:
    """The corruption sentinel: `nan_scan(state) -> (B,) bool` tensor, true
    for a slot whose cache rows hold a NaN (`cache_nan`, e.g.
    `steps.nan_cache_slots`). One pass over the cache a chunk when the
    session runs with `nan_check`."""

    @torch.inference_mode()
    def nan_scan(state):
        return cache_nan(state["cache"])

    return nan_scan


def make_slot_corrupt(*, cache_fill: Callable) -> Callable:
    """Fault injection: `corrupt(state, mask) -> state` sets the masked
    slots' float cache rows to NaN in place (`cache_fill`, e.g.
    `steps.fill_cache_slots`; integer rows untouched)."""

    @torch.inference_mode()
    def corrupt(state, mask):
        cache_fill(state["cache"], _as_index(mask, state["tok"].device,
                                             torch.bool), float("nan"))
        return state

    return corrupt


# ----------------------------------------------------------------------------
# Multi-step training
# ----------------------------------------------------------------------------

def make_train_chunk(train_step: Callable) -> Callable:
    """`chunk(state, batches) -> (state, metrics)`: one `train_step` for
    each leading-axis slice of the stacked `batches`, every metric stacked
    to shape (K, ...). The reference scans the steps in one compiled
    program with the state donated; the port runs them back to back on
    the card, the state updated in place, and reads nothing back to the
    host: the loop syncs once a chunk, when it reads the loss. (A captured
    train step, one CUDA graph, is not part of the port yet: ROADMAP.)"""

    def chunk(state, batches):
        rows = []
        for i in range(len(next(iter(batches.values())))):
            state, m = train_step(state, {k: v[i]
                                          for k, v in batches.items()})
            rows.append(m)
        return state, {k: torch.stack([torch.as_tensor(r[k]) for r in rows])
                       for k in rows[0]}

    return chunk


def stack_batches(batches: list) -> dict:
    """Stack K batches (dicts of tensors or arrays) on a new leading step
    axis, as tensors."""
    return {k: torch.stack([torch.as_tensor(b[k]) for b in batches])
            for k in batches[0]}

"""Execution engine of the serving session (the port of the session half
of `repro.runtime.engine`).

The reference compiles K decode steps into one `lax.scan` program with
the slot-pool state donated through it. Here the K steps are a Python
loop over the same per-slot state tensors, updated in place where the
reference donates them; the host reads the device once at the start of a
chunk (how many steps any slot still needs) and once at its end
(`ServeSession.poll` harvests the tokens), so the host still syncs once
per K tokens.

The reference skips the model body with `lax.cond` on each step at which
every slot is done. Without a device-side conditional the port bounds the
chunk at its start instead: it runs the steps the slowest live slot still
needs (its remaining prompt plus its remaining budget) and none once
every slot is done. A chunk in which EOS ends every slot early still runs
its remaining steps; those steps emit nothing and change no slot's
tokens, position or counters, exactly as skipped steps do. (A per-step
device skip needs CUDA-graph conditional nodes: a later PR.)

On the GPU one session step is captured as a CUDA graph and replayed: the
step's ~1,800 launches from Python become one, which is what the
reference gets from compiling the scan.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

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


class _StepGraph:
    """One session step captured as a CUDA graph over a session's state
    tensors (every update keeps them in place), replayed for each later
    step: one launch instead of the ~1,800 the step issues from Python.

    Construction runs one step eagerly on a side stream (the warm-up
    capture needs, and a real step of the session), then captures the next
    one without running it. A kernel wrapper counts a launch when it is
    called, so it counts the captured launches once; their executions in
    the replays are seen only by a device trace
    (`kernels.launches.traced_launches`)."""

    def __init__(self, decode_step, params, state, eos_id):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.first = _session_step(decode_step, params, state, eos_id)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.out = _session_step(decode_step, params, state, eos_id)

    def replay(self):
        self.graph.replay()
        return self.out


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
    first step (kept in ``state["step_graph"]``) and replayed for every
    later step: the same kernels on the same tensors, so the same results.
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
                state["step_graph"] = _StepGraph(decode_step, params, state,
                                                 eos_id)
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

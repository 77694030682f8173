"""Cluster/Session façade for the port (the serving half of
`repro.cluster.session`):

    cluster = Cluster("qwen3-14b")                  # device defaults to cuda
    with cluster.policy("fused"):
        prog = cluster.compile(ServeSessionProgram(slots=8, paged=True))
    sess = prog.open()                              # a live ServeSession
    batch = cluster.compile(ServeProgram(batch=8, max_new=64, chunk=16))
    out = batch.run()                               # tokens + stats

Entry points run on the card: `Cluster(arch)` with no `device` means
"cuda" and raises when CUDA is absent; tests pass ``device="cpu"``.
`Cluster.compile` memoizes programs in the cluster's `CompileCache`, keyed
on (spec, arch, device, policy knobs). Training, dry-run, bench and
sharded-session programs wait for later slices (ROADMAP Queue 1 H-K).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cluster.policy import KernelPolicy, as_policy, use_policy
from repro_torch.configs import get as get_arch
from repro_torch.configs.registry import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import steps
from repro_torch.runtime import engine
from repro_torch.runtime.compile_cache import CompileCache, Graphed
from repro_torch.runtime.serve_loop import ServeLoop, chunked_latency_stats


@dataclasses.dataclass(frozen=True)
class ServeProgram:
    """Batched greedy decoding of one fixed batch against a KV cache."""

    batch: int = 4
    max_seq: int = 64
    max_new: int = 16
    seed: int = 0
    eos_id: int | None = None
    chunk: int = 16                        # decode steps per host sync:
    #   1 = per-token host loop; K > 1 = the K-step engine, one CUDA graph
    #   a chunk on the card (runtime/engine.py)


@dataclasses.dataclass(frozen=True)
class ServeSessionProgram:
    """Request-level serving: a slot pool with continuous batching.

    `paged=True` swaps the per-slot private KV layout for the shared paged
    pool with copy-on-write prefix reuse (`runtime/kvpool.py`).

    The SLO and robustness knobs of the reference program (shedding,
    preemption, watchdog, NaN scan, snapshots) are ROADMAP Queue 1 item 8:
    they are declared here so that a spec written for the reference fails
    loudly, and any value that would engage one raises NotImplementedError
    when the program is compiled."""

    slots: int = 4
    max_seq: int = 64
    max_prompt: int = 8
    max_new: int = 16
    seed: int = 0
    eos_id: int | None = None
    chunk: int = 16
    max_queue: int | None = None
    admission: str = "fifo"
    paged: bool = False
    page_size: int = 16
    n_pages: int | None = None             # None -> slots * pages_per_slot
    #   + 1 (the trash page)
    prefix_cache: bool = True
    shed_watermark: int | None = None      # item 8
    preempt: bool = False                  # item 8
    watchdog_s: float | None = None        # item 8
    nan_check: bool = False                # item 8
    snapshot_every: int | None = None      # item 8

    def check_ported(self) -> None:
        engaged = [k for k, off in (("shed_watermark", None),
                                    ("preempt", False),
                                    ("watchdog_s", None),
                                    ("nan_check", False),
                                    ("snapshot_every", None))
                   if getattr(self, k) != off]
        if self.admission != "fifo":
            engaged.append(f"admission={self.admission!r}")
        if engaged:
            raise NotImplementedError(
                f"{', '.join(engaged)}: shedding, preemption, priority "
                f"admission, the watchdog, fault scans and snapshots are "
                f"ROADMAP Queue 1 item 8")


# the reference's program specs the port does not define yet, and the
# ROADMAP Queue 1 item that brings each
UNPORTED = {"TrainProgram": "H (item 11, training)",
            "ShardedServeSessionProgram": "I (item 9, groups)",
            "BenchProgram": "J (item 13, benchmarks)",
            "DryRunProgram": "K (item 14, the XLA-only modules)"}


class Cluster:
    """The substrate: arch + device + kernel policy + compiled programs."""

    def __init__(self, arch: "str | ArchConfig", *, device=None,
                 policy: "KernelPolicy | str | None" = None):
        self.arch: ArchConfig = get_arch(arch) if isinstance(arch, str) \
            else arch
        self.device = resolve_device(device)
        self._policy = as_policy(policy)
        self.compile_cache = CompileCache()

    @property
    def kernel_policy(self) -> KernelPolicy:
        return self._policy

    def policy(self, policy: "KernelPolicy | str | None" = None, **kwargs):
        """Scope a kernel policy on this cluster::

            with cluster.policy("fused"):              # a mode string
            with cluster.policy(mode="tuned", overrides={"matmul": "reference"}):

        Inside the block the policy is both the ambient one and the
        default that `compile` captures. Keywords are KernelPolicy fields
        (block overrides still raise: ROADMAP Queue 1 item 12)."""
        if policy is None:
            pol = KernelPolicy(**kwargs) if kwargs else self._policy
        else:
            pol = as_policy(policy)
            if kwargs:
                pol = dataclasses.replace(pol, **kwargs)
        return _PolicyScope(self, pol)

    def compile(self, spec) -> "Program":
        """Program spec -> compiled Program, memoized in the compile cache
        keyed on (spec, arch, device, policy knobs)."""
        builders = {ServeProgram: CompiledServe,
                    ServeSessionProgram: CompiledServeSession}
        name = type(spec).__name__
        if name in UNPORTED:
            raise NotImplementedError(
                f"{name}: the port does not define it yet (ROADMAP Queue 1 "
                f"{UNPORTED[name]})")
        try:
            builder = builders[type(spec)]
        except KeyError:
            raise TypeError(f"Cluster.compile expects a program spec, got "
                            f"{name}") from None
        key = (name, spec, self.arch.name, str(self.device),
               self._policy.fingerprint())
        return self.compile_cache.get(
            key, lambda: builder(self, spec, self._policy))


class _PolicyScope:
    def __init__(self, cluster: Cluster, pol: KernelPolicy):
        self._cluster = cluster
        self._pol = pol
        self._prev = None
        self._cm = None

    def __enter__(self) -> KernelPolicy:
        self._prev = self._cluster._policy
        self._cluster._policy = self._pol
        self._cm = use_policy(self._pol)
        return self._cm.__enter__()

    def __exit__(self, *exc):
        try:
            return self._cm.__exit__(*exc)
        finally:
            self._cluster._policy = self._prev


class Program:
    """A compiled program bound to its cluster: `.run()` and `.report()`.
    Subclasses hold the step functions and their captured graphs."""

    kind = "program"

    def __init__(self, cluster: Cluster, spec, policy: KernelPolicy):
        self.cluster = cluster
        self.spec = spec
        self.policy = policy
        self._last_run: dict | None = None

    def run(self, **kwargs) -> dict:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.cluster.device

    def init_params(self, seed: int | None = None):
        """Random parameters on the cluster's device from a seeded
        torch.Generator."""
        seed = self.spec.seed if seed is None else seed
        return steps.init_params(self.cluster.arch, seed, device=self.device,
                                 max_seq=self.spec.max_seq)

    def report(self) -> dict:
        """Program metadata + (when run) a result summary."""
        out = {
            "kind": self.kind,
            "arch": self.cluster.arch.name,
            "device": str(self.device),
            "spec": dataclasses.asdict(self.spec),
            "policy": self.policy.describe(),
            "compile_cache": {"hits": self.cluster.compile_cache.hits,
                              "misses": self.cluster.compile_cache.misses},
        }
        if self._last_run is not None:
            out["result"] = {k: v for k, v in self._last_run.items()
                             if k != "params"}
        return out


class CompiledServe(Program):
    """Batched greedy decoding of one fixed batch.

    The decode step runs as captured CUDA graphs on the card: prompt
    ingestion and the per-token path (`chunk=1`) replay one step's graph
    (`Graphed`, the port's jit), and `chunk > 1` runs the K-step
    `DecodeEngine`, one graph a chunk length. Both are built here, once per
    compiled program, so repeated `run()`s replay the graphs the first one
    captured.

    A captured graph writes to the addresses it was captured on, so the
    program keeps one KV cache (`cache`) and every `run` zeroes it in
    place: each run starts from a fresh cache, never from a new one. For
    the same reason `run(params=None)` uses one set of random parameters
    (`init_params()` with the spec's seed), made at the first such run and
    kept; another parameter tree is captured anew."""

    kind = "serve"

    def __init__(self, cluster, spec: ServeProgram, policy):
        super().__init__(cluster, spec, policy)
        step = steps.make_decode_step(cluster.arch, max_seq=spec.max_seq,
                                      policy=policy)
        self.decode = Graphed(step, copied=(2,))
        self.engine = (engine.DecodeEngine(step, spec.chunk,
                                           eos_id=spec.eos_id)
                       if spec.chunk > 1 else None)
        self.cache = None
        self._params = None

    def captures(self) -> int:
        """CUDA graphs this program has captured (0 on the CPU)."""
        fns = [self.decode] + (list(self.engine._chunk_fns.values())
                               if self.engine is not None else [])
        return sum(fn.graphs.misses for fn in fns)

    def _fresh_cache(self):
        cfg, spec = self.cluster.arch, self.spec
        if self.cache is None:
            self.cache = steps.init_cache(
                cfg, spec.batch, steps.decode_cache_len(cfg, spec.max_seq),
                device=self.device)
        else:
            with torch.inference_mode():
                for c in self.cache.values():
                    c.zero_()
        return self.cache

    def run(self, params=None, prompt=None) -> dict:
        """Greedy decode `max_new` tokens per slot. `prompt` (B, P) is fed
        token by token through the decode step first, at positions 0..P-1
        (continuous-batching-style ingest); generation then continues from
        the last sampled token at position P."""
        spec = self.spec
        if params is None:
            if self._params is None:
                self._params = self.init_params()
            params = self._params
        cache = self._fresh_cache()
        start = np.zeros((spec.batch, 1), np.int32)
        pos0 = 0
        if prompt is not None:
            prompt = np.asarray(prompt, np.int32)
            tok = None
            for t in range(prompt.shape[1]):
                cache, tok = self.decode(
                    params, cache,
                    {"tokens": torch.as_tensor(prompt[:, t:t + 1],
                                               device=self.device),
                     "pos": t})
            start, pos0 = tok.cpu().numpy().astype(np.int32), prompt.shape[1]
        loop = ServeLoop(self.decode, params, cache, batch_size=spec.batch,
                         eos_id=spec.eos_id, chunk=spec.chunk,
                         engine=self.engine)
        out = loop.generate(start, max_new=spec.max_new, start_pos=pos0)
        result = {"tokens": out, "stats": loop.stats()}
        self._last_run = {"stats": result["stats"],
                          "tokens_shape": tuple(out.shape)}
        return result

    def report(self) -> dict:
        return dict(super().report(), captures=self.captures())


class CompiledServeSession(Program):
    """Request-level serving: slot pool + scheduler + session cell, bound
    to its cluster's device and the kernel policy it was compiled under.
    `open()` hands out a live `ServeSession`; `run()` is the one-shot path
    (one request per slot, drain) with the legacy `ServeProgram`-shaped
    result."""

    kind = "serve_session"

    def __init__(self, cluster: Cluster, spec: ServeSessionProgram,
                 policy: KernelPolicy):
        spec.check_ported()
        super().__init__(cluster, spec, policy)
        self._last_session = None
        cfg = cluster.arch
        step = steps.make_decode_step(cfg, max_seq=spec.max_seq,
                                      policy=policy)
        self._chunk_fn = engine.session_chunk_fn(step, spec.chunk,
                                                 eos_id=spec.eos_id)
        self._page_copy_fn = None
        if spec.paged:
            pps = -((spec.max_seq + 1) // -spec.page_size)   # ceil
            self._pages_per_slot = pps
            self._n_pages = (spec.n_pages if spec.n_pages is not None
                             else spec.slots * pps + 1)      # +1: trash page
            ops = steps.make_paged_cache_ops(
                cfg, spec.slots, steps.decode_cache_len(cfg, spec.max_seq))
            self._refill_fn = engine.make_paged_session_refill(
                cache_zero=ops["zero_slots"])
            self._page_copy_fn = engine.make_page_copy(ops["copy_pages"])
        else:
            self._refill_fn = engine.make_session_refill(
                cache_zero=steps.zero_cache_slots)

    def _make_state(self):
        cfg, spec = self.cluster.arch, self.spec
        clen = steps.decode_cache_len(cfg, spec.max_seq)
        if spec.paged:
            cache = steps.init_paged_cache(cfg, spec.slots, clen,
                                           n_pages=self._n_pages,
                                           page_size=spec.page_size,
                                           device=self.device)
            return engine.init_session_state(
                cache, spec.slots, spec.max_prompt,
                pages_per_slot=self._pages_per_slot, device=self.device)
        cache = steps.init_cache(cfg, spec.slots, clen, device=self.device)
        return engine.init_session_state(cache, spec.slots, spec.max_prompt,
                                         device=self.device)

    def open(self, params=None, faults=None, durable_dir=None):
        """A fresh `ServeSession` over this cell (own slot pool, queue and
        stall clock). Fault plans and durable directories are ROADMAP
        Queue 1 item 8."""
        from repro_torch.runtime.kvpool import PagedKV
        from repro_torch.runtime.serve_loop import ServeSession

        if faults is not None or durable_dir is not None:
            raise NotImplementedError("fault injection and durable serving "
                                      "are ROADMAP Queue 1 item 8")
        spec = self.spec
        if params is None:
            params = self.init_params()
        kv = None
        if spec.paged:
            kv = PagedKV(self._n_pages, spec.page_size, spec.slots,
                         self._pages_per_slot,
                         prefix_cache=spec.prefix_cache)
        sess = ServeSession(self._chunk_fn, self._refill_fn, params,
                            self._make_state(), n_slots=spec.slots,
                            chunk=spec.chunk, max_prompt=spec.max_prompt,
                            max_seq=spec.max_seq, eos_id=spec.eos_id,
                            max_queue=spec.max_queue, kv=kv,
                            page_copy_fn=self._page_copy_fn)
        self._last_session = sess
        return sess

    def run(self, params=None, prompt=None, max_new: int | None = None):
        """One-shot: one request per slot (the start token 0, or row i of
        `prompt` (B, P)), drain, and return the legacy ``{"tokens": (B, W),
        "stats": ...}`` — a prompt's first sampled token in column 0, as
        the reference's `run` does. `stats` is `ServeLoop.stats()`-shaped
        (`_legacy_stats`) with the session's own stats under
        ``"session"``."""
        spec = self.spec
        max_new = spec.max_new if max_new is None else max_new
        sess = self.open(params=params)
        if prompt is None:
            rows = [np.zeros(1, np.int32)] * spec.slots
            per_req = max_new
        else:
            prompt = np.asarray(prompt)
            rows = [prompt[i] for i in range(spec.slots)]
            # +1: the last prefill step's output (legacy column 0) counts
            # toward the session budget but not toward legacy emitted
            per_req = max_new + 1
        handles = [sess.submit(r, per_req) for r in rows]
        sess_stats = sess.drain()
        toks = [h.result() for h in handles]
        if prompt is None:
            toks = [np.concatenate([[0], t]).astype(np.int32) for t in toks]
        w = max(t.size for t in toks)
        out = np.full((spec.slots, w),
                      spec.eos_id if spec.eos_id is not None else 0,
                      np.int32)
        for i, t in enumerate(toks):
            out[i, :t.size] = t
        stats = self._legacy_stats(sess, handles,
                                   gen_offset=0 if prompt is None else 1)
        stats["session"] = sess_stats
        self._last_run = {"stats": {k: v for k, v in stats.items()
                                    if k != "session"},
                          "session": sess_stats,
                          "tokens_shape": tuple(out.shape)}
        return {"tokens": out, "stats": stats}

    def _legacy_stats(self, sess, handles, gen_offset: int) -> dict:
        """`ServeLoop.stats()`-shaped dict from a drained one-shot session
        (per-token percentiles over post-warm-up chunks, stall ledger,
        emitted_per_slot in legacy generation-step counting)."""
        st = chunked_latency_stats(sess.chunk_latencies)
        st["chunk"] = sess.chunk
        st["stall"] = sess.clock.report()
        st["emitted_per_slot"] = [int(h.tokens.size - gen_offset)
                                  for h in handles]
        if self.spec.eos_id is not None:
            st["finished_slots"] = sum(h.hit_eos for h in handles)
        return st

    def report(self) -> dict:
        out = super().report()
        if self._last_session is not None:
            out["session"] = self._last_session.stats()
        return out

"""Cluster/Session façade for the port (the train and serve halves of
`repro.cluster.session`):

    cluster = Cluster("qwen3-14b")                  # device defaults to cuda
    with cluster.policy("fused"):
        prog = cluster.compile(ServeSessionProgram(slots=8, paged=True))
        train = cluster.compile(TrainProgram(num_steps=100))
    sess = prog.open()                              # a live ServeSession
    batch = cluster.compile(ServeProgram(batch=8, max_new=64, chunk=16))
    out = batch.run()                               # tokens + stats
    report = train.run()                            # the TrainLoop's report

Entry points run on the card: `Cluster(arch)` with no `device` means
"cuda" and raises when CUDA is absent; tests pass ``device="cpu"``.
`Cluster.compile` memoizes programs in the cluster's `CompileCache`, keyed
on (spec, arch, device, policy knobs). `Cluster(None, tune_db=path)` is a
kernel-only cluster (a policy and the tune records, no model): it
warm-starts the tuning layer from a `kernels.tunedb.TuneDB`. Dry-run,
bench and sharded-session programs wait for later slices (ROADMAP Queue 1
I-K).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import numpy as np
import torch

from repro_torch.cluster.policy import KernelPolicy, as_policy, use_policy
from repro_torch.configs import get as get_arch
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs.registry import kernel_tunes
from repro_torch.device import resolve_device
from repro_torch.kernels import pipeline, tunedb
from repro_torch.models import steps
from repro_torch.runtime import engine
from repro_torch.runtime.compile_cache import CompileCache, Graphed
from repro_torch.runtime.serve_loop import ServeLoop, chunked_latency_stats
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig


@dataclasses.dataclass(frozen=True)
class TrainProgram:
    """A training run on the synthetic stream."""

    num_steps: int = 100
    batch: int = 4
    seq: int = 128
    seed: int = 0
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch-train")
    checkpoint_every: int | None = None    # None -> max(num_steps // 2, 1)
    log_every: int | None = None           # None -> max(num_steps // 10, 1)
    warmup: int | None = None              # None -> max(num_steps // 10, 1)
    resume: bool = False                   # restore latest checkpoint first
    double_buffer: bool = False            # prefetch feed (DMA analogue)
    steps_per_sync: int = 1                # steps a host sync (> 1: the
    #   K-step train chunk; straggler/logging sample at chunk granularity)


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

    Compiles to a `CompiledServeSession`; `open()` returns a live
    `ServeSession`. The SLO and robustness knobs configure its priority
    admission (`admission`, `shed_watermark`, `aging_rounds`), slot
    preemption (`preempt`), the per-chunk watchdog (`watchdog_s` ->
    `SessionWedged`), fault recovery (`max_retries`, `retry_backoff_s`)
    and the NaN scan (`nan_check`); `open(faults=FaultPlan(...))` arms
    scripted faults, `open(durable_dir=...)` the journal and snapshots.

    `paged=True` swaps the per-slot private KV layout for the shared paged
    pool with copy-on-write prefix reuse (`runtime/kvpool.py`). A paged
    session runs with preemption off (slot snapshots do not carry page
    tables), as the reference's does."""

    slots: int = 4                         # slot-pool size (batch rows)
    max_seq: int = 64
    max_prompt: int = 8                    # per-slot prompt buffer length
    max_new: int = 16                      # one-shot run() / submit default
    seed: int = 0
    eos_id: int | None = None
    chunk: int = 16                        # decode steps per host sync
    max_queue: int | None = None           # bounded-queue backpressure
    admission: str = "fifo"                # or "longest_prefix"
    shed_watermark: int | None = None      # total queue depth that sheds
    #   best-effort work (latency/throughput get QueueFull instead)
    aging_rounds: int = 8                  # anti-starvation: +1 effective
    #   class rank per this many admission rounds waited
    preempt: bool = True                   # latency may snapshot + evict a
    #   lower-class running slot (bit-identical resume)
    watchdog_s: float | None = None        # per-chunk device-wait bound;
    #   None = wait forever (poll(timeout_s=...) still overrides)
    max_retries: int = 2                   # fault-recovery restarts per
    #   request before it fails with "retries_exhausted"
    retry_backoff_s: float = 0.05          # base of the exponential
    #   re-admission backoff after a fault restart
    nan_check: bool = False                # scan cache rows for NaN every
    #   chunk (on by itself when a FaultPlan scripts corruption)
    paged: bool = False                    # shared paged KV pool with COW
    #   prefix reuse (forces preempt off)
    page_size: int = 16                    # tokens per KV page
    n_pages: int | None = None             # None -> slots * pages_per_slot
    #   + 1 (the trash page)
    prefix_cache: bool = True
    snapshot_every: int | None = None      # chunks between bit-exact
    #   session snapshots (needs open(durable_dir=...)); None = journal only
    journal_fsync: bool | int = True       # True/False/every-K (`Journal`)
    scrub_pages: int = 2                   # stamped pages re-verified per
    #   boundary by the integrity scrub (paged; 0 disables)


# the reference's program specs the port does not define yet, and the
# ROADMAP Queue 1 item that brings each
UNPORTED = {"ShardedServeSessionProgram": "I (item 9, groups)",
            "BenchProgram": "J (item 13, benchmarks)",
            "DryRunProgram": "K (item 14, the XLA-only modules)"}


class Cluster:
    """The substrate: arch + device + kernel policy + tune records +
    compiled programs.

    `arch` may be an arch name, an ArchConfig, or None for a kernel-only
    cluster (policy and tunes, no model: `compile` then raises).

    `tune_db` is the persistent timed-tune database: a
    `kernels.tunedb.TuneDB`, a path to open one, or None for the
    ``REPRO_TUNE_DB`` default (which may be unset: no persistence). When a
    DB resolves, the cluster warm-starts KERNEL_TUNES from its records of
    this device's backend ("cuda" or "torch_cpu") and the policy's mode,
    so `tuned_call` hits instead of racing, and installs it as the active
    write-through target; ``tune_db_warm`` counts the warm start and
    `Program.report()` shows it.
    """

    def __init__(self, arch: "str | ArchConfig | None" = None, *,
                 device=None, policy: "KernelPolicy | str | None" = None,
                 tune_db: "tunedb.TuneDB | str | None" = None):
        self.arch: ArchConfig | None = (
            get_arch(arch) if isinstance(arch, str) else arch)
        self.device = resolve_device(device)
        self._policy = as_policy(policy)
        self.compile_cache = CompileCache()
        self.tune_db = tunedb.resolve_db(tune_db)
        self.tune_db_warm = 0
        if self.tune_db is not None:
            self.tune_db_warm = self.tune_db.warm_start(
                backend=pipeline.backend_of(self.device),
                mode=self._policy.mode)
            tunedb.set_active_db(self.tune_db)

    def set_active_db(self) -> None:
        """Install this cluster's DB as the active write-through target
        (another cluster may have installed its own since)."""
        tunedb.set_active_db(self.tune_db)

    def tunes(self, kernel: str | None = None) -> list:
        """This cluster's view of the tune records (KERNEL_TUNES)."""
        recs = kernel_tunes()
        if kernel is not None:
            recs = [r for r in recs if r.kernel == kernel]
        return recs

    @property
    def kernel_policy(self) -> KernelPolicy:
        return self._policy

    def policy(self, policy: "KernelPolicy | str | None" = None, **kwargs):
        """Scope a kernel policy on this cluster::

            with cluster.policy("fused"):              # a mode string
            with cluster.policy(mode="tuned", overrides={"matmul": "reference"}):

        Inside the block the policy is both the ambient one and the
        default that `compile` captures. Keywords are KernelPolicy fields,
        ``tuning`` and dict overrides (a pinned plan) included."""
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
                    ServeSessionProgram: CompiledServeSession,
                    TrainProgram: CompiledTrain}
        name = type(spec).__name__
        if self.arch is None:
            raise ValueError(f"{name} needs an arch; this cluster was "
                             f"built without one (Cluster(arch=...))")
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
        if self.cluster.tune_db is not None:
            out["tunedb"] = dict(self.cluster.tune_db.describe(),
                                 warm_started=self.cluster.tune_db_warm)
        if self._last_run is not None:
            out["result"] = {k: v for k, v in self._last_run.items()
                             if k != "params"}
        return out


class CompiledTrain(Program):
    """A training run: `step` (`steps.make_train_step` under the program's
    policy, warmup-cosine over `num_steps`), `chunk` (the K-step train
    chunk, when ``steps_per_sync > 1``), `init_state(seed)` and `run()`,
    which drives a `TrainLoop` over the synthetic stream with checkpoints
    in ``checkpoint_dir``.

    With ``resume=True`` the run restores the latest checkpoint and the
    stream continues at its step (a batch is a pure function of (seed,
    step)), so a resumed run's losses are those of an uninterrupted one.
    (The reference's run restores the state but feeds the stream from
    batch 0 again.)"""

    kind = "train"

    def __init__(self, cluster, spec: TrainProgram, policy):
        super().__init__(cluster, spec, policy)
        n = spec.num_steps
        warmup = spec.warmup if spec.warmup is not None else max(n // 10, 1)
        self.step: Callable = steps.make_train_step(
            cluster.arch, schedule_kwargs={"warmup": warmup, "total": n},
            policy=policy)
        self.chunk: Callable | None = (
            engine.make_train_chunk(self.step)
            if spec.steps_per_sync > 1 else None)

    def init_state(self, seed: int | None = None):
        """A fresh train state on the cluster's device: parameters from
        `steps.init_params(cfg, seed)` (the spec's seed by default), zero
        moments, step 0."""
        seed = self.spec.seed if seed is None else seed
        return steps.init_train_state(self.cluster.arch, seed,
                                      device=self.device,
                                      max_seq=self.spec.seq)

    def _feed(self, start: int):
        from repro_torch.data import (BatchSpec, Distributor,
                                      DoubleBufferedFeed, Splitter,
                                      SyntheticLMStream, stream_batches)

        cfg, spec, device = self.cluster.arch, self.spec, self.device
        stream = SyntheticLMStream(BatchSpec(spec.batch, spec.seq, cfg.vocab),
                                   seed=spec.seed)
        dist = Distributor([device], Splitter([device]))
        if spec.double_buffer:
            # a chunk drains steps_per_sync batches a dispatch; the ring
            # holds a whole chunk so the drain does not wait on the producer
            return DoubleBufferedFeed(
                lambda s: dist.materialize(stream, s, device),
                depth=max(2, spec.steps_per_sync), start_step=start)
        return stream_batches(stream, dist, device, start)

    def run(self) -> dict:
        """The TrainLoop's report (final_step, preempted, wall_seconds,
        straggler_events, stall, steps_per_sync, metrics), plus "feed"
        (the double-buffered feed's stall report) and "params" (the
        trained parameters)."""
        spec = self.spec
        n = spec.num_steps
        cfg = TrainLoopConfig(
            total_steps=n,
            checkpoint_every=(spec.checkpoint_every
                              if spec.checkpoint_every is not None
                              else max(n // 2, 1)),
            log_every=(spec.log_every if spec.log_every is not None
                       else max(n // 10, 1)),
            checkpoint_dir=spec.checkpoint_dir,
            steps_per_sync=spec.steps_per_sync)
        loop = TrainLoop(cfg, self.step, self.init_state(), None,
                         train_chunk=self.chunk)
        start = 0
        if spec.resume:
            start = loop.maybe_resume()
        feed = loop.batch_iter = self._feed(start)
        try:
            report = loop.run(start_step=start)
        finally:
            if hasattr(feed, "close"):
                feed.close()
        if hasattr(feed, "stall_report"):
            report["feed"] = feed.stall_report()
        report["params"] = loop.state["params"]
        self._last_run = report
        return report


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
        super().__init__(cluster, spec, policy)
        if spec.admission not in ("fifo", "longest_prefix"):
            raise ValueError(f"unknown admission policy {spec.admission!r}")
        self._last_session = None
        cfg = cluster.arch
        step = steps.make_decode_step(cfg, max_seq=spec.max_seq,
                                      policy=policy)
        self._chunk_fn = engine.session_chunk_fn(step, spec.chunk,
                                                 eos_id=spec.eos_id)
        if spec.paged:
            # the fault programs route pool leaves by table; snapshot and
            # restore stay None: preemption is off under paging
            pps = -((spec.max_seq + 1) // -spec.page_size)   # ceil
            self._pages_per_slot = pps
            self._n_pages = (spec.n_pages if spec.n_pages is not None
                             else spec.slots * pps + 1)      # +1: trash page
            ops = steps.make_paged_cache_ops(
                cfg, spec.slots, steps.decode_cache_len(cfg, spec.max_seq))
            self._refill_fn = engine.make_paged_session_refill(
                cache_zero=ops["zero_slots"])
            self._snapshot_fn = None
            self._restore_fn = None
            self._nan_scan_fn = engine.make_paged_nan_scan(ops["nan_slots"])
            self._corrupt_fn = engine.make_paged_slot_corrupt(
                ops["corrupt_slots"])
            self._page_copy_fn = engine.make_page_copy(ops["copy_pages"])
            self._page_scrub_fn = engine.make_page_scrub(ops["zero_pages"])
            # the page readback feeds the publish-time checksums and the
            # scrub; the page flip is the scripted silent corruption
            self._page_read_fn = engine.make_page_read(ops["read_pages"])
            self._page_flip_fn = engine.make_page_flip(ops["flip_pages"])
        else:
            self._refill_fn = engine.make_session_refill(
                cache_zero=steps.zero_cache_slots)
            self._snapshot_fn = engine.make_slot_snapshot(
                cache_take=steps.take_cache_slot)
            self._restore_fn = engine.make_slot_restore(
                cache_put=steps.put_cache_slot)
            self._nan_scan_fn = engine.make_nan_scan(
                cache_nan=steps.nan_cache_slots)
            self._corrupt_fn = engine.make_slot_corrupt(
                cache_fill=steps.fill_cache_slots)
            self._page_copy_fn = None
            self._page_scrub_fn = None
            self._page_read_fn = None
            self._page_flip_fn = None

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

    def open(self, params=None, faults=None, durable_dir=None,
             resume: bool = False, crash_hook=None, snapshot_every=None,
             journal_fsync=None, device=None, journal_group=None):
        """A fresh `ServeSession` over this cell (own slot pool, queue,
        scheduler and stall clock). `faults` arms a `FaultPlan`.

        `durable_dir` turns on the durability layer: the request journal
        (committed once a poll) and, with ``snapshot_every``, periodic
        bit-exact session snapshots; `resume=True` recovers from an
        existing `durable_dir` after a crash (see `restore()`).
        `snapshot_every` / `journal_fsync` override the spec's values for
        this session (None keeps them). `crash_hook(chunk)` runs when a
        scripted crash fires (the default raises `SessionCrashed`).
        `device` places the session's parameters and state on another
        device than the cluster's; `journal_group` tags every journal
        event with a serving group id."""
        from repro_torch.runtime.kvpool import PagedKV
        from repro_torch.runtime.serve_loop import ServeSession

        spec = self.spec
        if params is None:
            params = self.init_params()
        make_state = self._make_state
        if device is not None:
            device = resolve_device(device)
            params = _to_device(params, device)
            make_state = lambda: _to_device(self._make_state(), device)
        kv = None
        if spec.paged:
            kv = PagedKV(self._n_pages, spec.page_size, spec.slots,
                         self._pages_per_slot,
                         prefix_cache=spec.prefix_cache)
        sess = ServeSession(
            self._chunk_fn, self._refill_fn, params, make_state(),
            n_slots=spec.slots, chunk=spec.chunk,
            max_prompt=spec.max_prompt, max_seq=spec.max_seq,
            eos_id=spec.eos_id, max_queue=spec.max_queue,
            admission=spec.admission, shed_watermark=spec.shed_watermark,
            aging_rounds=spec.aging_rounds,
            preempt=spec.preempt and not spec.paged,
            snapshot_fn=self._snapshot_fn, restore_fn=self._restore_fn,
            nan_scan_fn=self._nan_scan_fn, corrupt_fn=self._corrupt_fn,
            state_factory=make_state, watchdog_s=spec.watchdog_s,
            max_retries=spec.max_retries,
            retry_backoff_s=spec.retry_backoff_s,
            nan_check=spec.nan_check, kv=kv,
            page_copy_fn=self._page_copy_fn,
            page_scrub_fn=self._page_scrub_fn, faults=faults,
            durable_dir=durable_dir,
            snapshot_every=(spec.snapshot_every if snapshot_every is None
                            else snapshot_every),
            journal_fsync=(spec.journal_fsync if journal_fsync is None
                           else journal_fsync),
            page_read_fn=self._page_read_fn,
            page_flip_fn=self._page_flip_fn, scrub_pages=spec.scrub_pages,
            crash_hook=crash_hook, resume=resume,
            journal_group=journal_group)
        self._last_session = sess
        return sess

    def restore(self, durable_dir, params=None, faults=None, **kwargs):
        """Resume a crashed session from its `durable_dir`: the latest
        snapshot (if any) is copied into a fresh state in place, the
        journal tail replayed, and a live session returned. Requests that
        finished before the crash surface on `sess.recovered`; in-flight
        ones resume (bit for bit from the snapshot, or by a new prefill
        with the journal-committed prefix suppressed): delivery stays
        exactly once. `kwargs` go to `open`."""
        return self.open(params=params, faults=faults,
                         durable_dir=durable_dir, resume=True, **kwargs)

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


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree

"""Cluster/Session façade for the port (the serving half of
`repro.cluster.session`):

    cluster = Cluster("qwen3-14b")                  # device defaults to cuda
    with cluster.policy("fused"):
        prog = cluster.compile(ServeSessionProgram(slots=8, paged=True))
    sess = prog.open()                              # a live ServeSession

Entry points run on the card: `Cluster(arch)` with no `device` means
"cuda" and raises when CUDA is absent; tests pass ``device="cpu"``.
Training, batch serving, dry-run, bench and sharded-session programs wait
for later slices (ROADMAP Queue 1 items 8-14).
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


class Cluster:
    """The substrate: arch + device + kernel policy + programs."""

    def __init__(self, arch: "str | ArchConfig", *, device=None,
                 policy: "KernelPolicy | str | None" = None):
        self.arch: ArchConfig = get_arch(arch) if isinstance(arch, str) \
            else arch
        self.device = resolve_device(device)
        self._policy = as_policy(policy)

    def policy(self, policy: "KernelPolicy | str | None" = None):
        """Scope a kernel policy on this cluster: inside the block it is
        the ambient policy and the default that `compile` captures."""
        return _PolicyScope(self, as_policy(policy) if policy is not None
                            else self._policy)

    def compile(self, spec) -> "CompiledServeSession":
        if isinstance(spec, ServeSessionProgram):
            return CompiledServeSession(self, spec, self._policy)
        raise NotImplementedError(
            f"{type(spec).__name__}: the port serves ServeSessionProgram so "
            f"far (the other programs are ROADMAP Queue 1 items 8-13)")


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


class CompiledServeSession:
    """Request-level serving: slot pool + scheduler + session cell, bound
    to its cluster's device and the kernel policy it was compiled under.
    `open()` hands out a live `ServeSession`; `run()` is the one-shot
    path (one request per slot, drain)."""

    def __init__(self, cluster: Cluster, spec: ServeSessionProgram,
                 policy: KernelPolicy):
        spec.check_ported()
        self.cluster = cluster
        self.spec = spec
        self.policy = policy
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

    @property
    def device(self) -> torch.device:
        return self.cluster.device

    def init_params(self, seed: int | None = None):
        """Random parameters on the cluster's device from a seeded
        torch.Generator."""
        seed = self.spec.seed if seed is None else seed
        return steps.init_params(self.cluster.arch, seed, device=self.device,
                                 max_seq=self.spec.max_seq)

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
        return sess

    def run(self, params=None, prompt=None, max_new: int | None = None):
        """One-shot: one request per slot (the start token 0, or row i of
        `prompt` (B, P)), drain, and return ``{"tokens": (B, W), "stats":
        session stats}`` — a prompt's first sampled token in column 0, as
        the reference's `run` does."""
        spec = self.spec
        max_new = spec.max_new if max_new is None else max_new
        sess = self.open(params=params)
        if prompt is None:
            rows = [np.zeros(1, np.int32)] * spec.slots
            per_req = max_new
        else:
            prompt = np.asarray(prompt)
            rows = [prompt[i] for i in range(spec.slots)]
            per_req = max_new + 1
        handles = [sess.submit(r, per_req) for r in rows]
        stats = sess.drain()
        toks = [h.result() for h in handles]
        if prompt is None:
            toks = [np.concatenate([[0], t]).astype(np.int32) for t in toks]
        w = max(t.size for t in toks)
        out = np.full((spec.slots, w),
                      spec.eos_id if spec.eos_id is not None else 0,
                      np.int32)
        for i, t in enumerate(toks):
            out[i, :t.size] = t
        return {"tokens": out, "stats": stats}

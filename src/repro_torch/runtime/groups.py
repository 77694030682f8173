"""Cluster-of-clusters serving: shard a session across devices (the port of
`repro.runtime.groups`).

MemPool scales past one cluster by tiling the hierarchy — PEs form
tiles, tiles form groups, groups form the cluster — and keeping the
latency *within* a group flat while traffic *between* groups pays the
interconnect. This module is the serving-side analogue: the devices are
partitioned into **serving groups**, each owning a full session cell
(slot pool, paged KV pool + prefix cache, stall ledger, fault hooks,
journal), and a single `ShardedServeSession` front-end keeps the
familiar `submit / poll / stream / cancel / drain` surface while a
two-level scheduler decides *which group* a request lands in before that
group's own `SlotScheduler` decides *which slot*.

Placement is locality-aware the same way MemPool's router is: the
`MeshScheduler` scores each group with the paper's `TopologyModel`,
treating the fraction of a request's prompt already resident in the
group's warm `PrefixCache` as the local-access probability `p_local`
and the group's occupancy as the injected load. A request whose prompt
prefix is cached in group g models as mostly-local traffic there (low
latency -> routed there); a cold request falls through to pure load
balancing. Groups can be drained (stop placing, finish in-flight) or
quarantined (wedged — degraded capacity, not a dead session).

Layering: this module is host-side orchestration over N ordinary
`ServeSession`s and owns no device code. Building the per-group sessions
(sharing the compiled chunk program, placing each group's parameters and
state on its device, carving durable subdirectories) is the cluster
layer's job (`cluster.session.CompiledShardedServeSession`); everything
here works on any list of sessions, test doubles included.

On the card, `poll` runs each group's chunk on a worker thread under
`torch.cuda.device(group.device)` (a thread's current device is its own).
Groups that share a card share its work queue: each group's device wait
(`StallClock.sync`) then covers the other groups' work too, and the
summed `tokens_per_s` is not a throughput of the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.interconnect import TOP_H, TopologyModel
from repro_torch.device import distinct_devices

from .engine import StallClock
from .faults import SessionWedged
from .scheduler import QueueFull


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """How the devices are carved into serving groups.

    `devices[g]` is where group g's parameters and state live. With fewer
    devices than groups the assignment wraps (several groups time-share a
    device) — `degraded` flags that: the scheduling is intact but compute
    overlap is lost, which is what a one-card or CPU run exercises.
    Devices compare by value: two `torch.device("cuda", 0)` are one card.
    """
    n_groups: int
    devices: tuple = ()

    @classmethod
    def build(cls, n_groups: int, devices: Sequence | None = None
              ) -> "GroupPlan":
        """`devices` None: every CUDA device torch sees (none on a host
        without CUDA, an empty plan)."""
        if n_groups < 1:
            raise ValueError(f"n_groups must be >= 1, got {n_groups}")
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = list(devices)
        if not devices:
            return cls(n_groups=n_groups, devices=())
        return cls(n_groups=n_groups,
                   devices=tuple(devices[g % len(devices)]
                                 for g in range(n_groups)))

    @property
    def degraded(self) -> bool:
        """True when groups share devices (round-robin wrapped)."""
        return distinct_devices(self.devices) < self.n_groups


@dataclasses.dataclass
class GroupView:
    """One group's load + locality snapshot, as the placement layer
    sees it. Built per-submit; `overlap_pages` is the measured prefix-
    cache overlap with the request being placed (0 when unpaged)."""
    gid: int
    free_slots: int
    queued: int
    usable_slots: int
    max_queue: int | None
    overlap_pages: int = 0


class MeshScheduler:
    """Level-1 placement: request -> serving group.

    Scores every eligible group with the paper's M/D/1 topology model
    (`TopologyModel.avg_latency`): the fraction of the prompt resident
    in the group's prefix cache is the local-access probability (warm
    cache -> mostly-local traffic -> low modeled latency) and the
    group's slot+queue occupancy is the injected load (busy group ->
    queueing term grows). Ties break on lifetime placements then gid,
    so equal groups round-robin deterministically.

    Quarantined groups (wedged sessions) and draining groups receive
    nothing; a group with a full class queue or zero usable slots is
    skipped for this request. When no group is eligible the placement
    raises `QueueFull` — the sharded analogue of a single session's
    bounded-queue backpressure.
    """

    def __init__(self, n_groups: int, *, page_size: int = 16,
                 topo_spec=TOP_H):
        if n_groups < 1:
            raise ValueError(f"n_groups must be >= 1, got {n_groups}")
        self.n_groups = n_groups
        self.page_size = max(int(page_size), 1)
        # each group plays the role of one tile: chance_local = 1/G
        self.topo = TopologyModel(topo_spec, n_tiles=max(n_groups, 1))
        self.placed = [0] * n_groups
        self.placements = 0
        self.locality_hits = 0
        self.rejections = 0
        self.quarantined: set[int] = set()
        self.draining: set[int] = set()

    # -- scoring ---------------------------------------------------------
    def score(self, view: GroupView, prompt_tokens: int) -> float:
        """Modeled latency of running this request in `view`'s group
        (lower is better): decreasing in prefix overlap, increasing in
        load."""
        covered = min(view.overlap_pages * self.page_size,
                      max(prompt_tokens - 1, 0))
        p_local = covered / max(prompt_tokens, 1)
        running = max(view.usable_slots - view.free_slots, 0)
        cap = view.usable_slots + (view.max_queue
                                   if view.max_queue is not None
                                   else view.usable_slots)
        injected = min((running + view.queued) / max(cap, 1), 1.0)
        return self.topo.avg_latency(injected, p_local=p_local)

    def eligible(self, view: GroupView) -> bool:
        return (view.gid not in self.quarantined
                and view.gid not in self.draining
                and view.usable_slots > 0
                and (view.max_queue is None
                     or view.queued < view.max_queue))

    def place(self, views: Sequence[GroupView], *,
              prompt_tokens: int = 1) -> int:
        """Pick the group for one request; returns its gid exactly once
        (never two groups). Raises `QueueFull` when no group can take
        work."""
        elig = [v for v in views if self.eligible(v)]
        if not elig:
            self.rejections += 1
            raise QueueFull(
                f"no serving group can accept work ({len(views)} groups: "
                f"{sorted(self.quarantined)} quarantined, "
                f"{sorted(self.draining)} draining)")
        best = min(elig, key=lambda v: (self.score(v, prompt_tokens),
                                        self.placed[v.gid], v.gid))
        self.placed[best.gid] += 1
        self.placements += 1
        if best.overlap_pages > 0:
            self.locality_hits += 1
        return best.gid

    # -- group lifecycle -------------------------------------------------
    def quarantine_group(self, gid: int) -> None:
        """Stop placing into a wedged group. In-flight work stays put;
        the session front-end skips the group's polls until recovery."""
        self._check(gid)
        self.quarantined.add(gid)

    def recover_group(self, gid: int) -> None:
        self._check(gid)
        self.quarantined.discard(gid)

    def drain_group(self, gid: int) -> None:
        """Stop placing into a group while it finishes in-flight work
        (e.g. ahead of maintenance). Unlike quarantine, the group keeps
        polling."""
        self._check(gid)
        self.draining.add(gid)

    def undrain_group(self, gid: int) -> None:
        self._check(gid)
        self.draining.discard(gid)

    def _check(self, gid: int) -> None:
        if not 0 <= gid < self.n_groups:
            raise ValueError(f"gid {gid} out of range "
                             f"[0, {self.n_groups})")

    def stats(self) -> dict:
        return {
            "placements": self.placements,
            "placed": list(self.placed),
            "locality_hits": self.locality_hits,
            "locality_rate": self.locality_hits / max(self.placements, 1),
            "rejections": self.rejections,
            "quarantined_groups": sorted(self.quarantined),
            "draining_groups": sorted(self.draining),
        }


@dataclasses.dataclass
class GroupRuntime:
    """One serving group: a full session cell on one device."""
    gid: int
    session: object                     # ServeSession (or a test double)
    device: object = None

    def overlap_pages(self, prompt) -> int:
        """Measured prefix-cache overlap (whole warm pages) between this
        group's paged KV and `prompt`. 0 when the group is unpaged."""
        kv = getattr(self.session, "kv", None)
        if kv is None:
            return 0
        return int(kv.match_pages(np.asarray(prompt, np.int32).reshape(-1)))

    def view(self, prompt=None) -> GroupView:
        lv = self.session.scheduler.load_view()
        return GroupView(
            gid=self.gid,
            free_slots=lv["free_slots"],
            queued=lv["queued"],
            usable_slots=lv["usable_slots"],
            max_queue=lv["max_queue"],
            overlap_pages=(self.overlap_pages(prompt)
                           if prompt is not None else 0))

    def on_device(self):
        """A context making this group's card the thread's current CUDA
        device (nothing for another device)."""
        dev = self.device
        if isinstance(dev, torch.device) and dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()


def _pooled_pct(sample_lists) -> dict:
    """Percentiles over the union of per-group raw samples (percentiles
    of percentiles would be meaningless, so pool the samples)."""
    xs = [t for samples in sample_lists for t in samples]
    pct = lambda q: (float(np.percentile(np.asarray(xs), q)) * 1e3
                     if xs else 0.0)
    return {"p50": pct(50), "p99": pct(99)}


class ShardedServeSession:
    """N serving groups behind the single-session API.

    `submit` runs level-1 placement (`MeshScheduler`) then delegates to
    the chosen group's `ServeSession.submit` (level 2: its own slot
    scheduler); the returned handle is the group's handle with a
    `.group` attribute stamped on. `poll` advances every live group by
    one chunk — concurrently on a thread pool when there is more than
    one group, since each group's device wait releases the GIL — and
    concatenates events in gid order. A group whose poll raises
    `SessionWedged` is quarantined: capacity degrades by one group, the
    session keeps serving, and `recover_group` folds it back in.

    Like `ServeSession`, the front-end is not thread-safe for
    concurrent *user* calls; the internal poll parallelism touches
    disjoint per-group state only.
    """

    def __init__(self, groups: Sequence[GroupRuntime], *,
                 mesh: MeshScheduler | None = None,
                 plan: GroupPlan | None = None):
        if not groups:
            raise ValueError("need at least one serving group")
        self.groups = list(groups)
        page_size = 16
        for g in self.groups:
            kv = getattr(g.session, "kv", None)
            if kv is not None:
                page_size = kv.pool.page_size
                break
        self.mesh = mesh or MeshScheduler(len(self.groups),
                                          page_size=page_size)
        self.plan = plan or GroupPlan(n_groups=len(self.groups),
                                      devices=tuple(g.device
                                                    for g in self.groups))
        self._pool = (ThreadPoolExecutor(
                          max_workers=len(self.groups),
                          thread_name_prefix="serve-group")
                      if len(self.groups) > 1 else None)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def _live(self) -> list[GroupRuntime]:
        return [g for g in self.groups
                if g.gid not in self.mesh.quarantined]

    # -- submission ------------------------------------------------------
    def submit(self, prompt, max_new: int, *, klass: str = "latency",
               deadline_s: float | None = None):
        """Place one request into a group and enqueue it there. The
        handle is the group session's handle; `handle.group` records the
        placement. Raises `QueueFull` when no group can take work."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        views = [g.view(prompt) for g in self.groups]
        gid = self.mesh.place(views, prompt_tokens=int(prompt.size))
        handle = self.groups[gid].session.submit(
            prompt, max_new, klass=klass, deadline_s=deadline_s)
        handle.group = gid
        return handle

    def cancel(self, handle) -> bool:
        gid = getattr(handle, "group", None)
        if gid is None:
            return any(g.session.cancel(handle) for g in self.groups)
        return self.groups[gid].session.cancel(handle)

    # -- the chunk boundary ----------------------------------------------
    def _poll_group(self, g: GroupRuntime, timeout_s):
        try:
            with g.on_device():
                return g.gid, g.session.poll(timeout_s), None
        except SessionWedged as e:
            return g.gid, [], e

    def poll(self, timeout_s: float | None = None) -> list:
        """Advance every live group by one chunk; returns the combined
        `(handle, new_tokens, done)` events in gid order. A wedged
        group is quarantined (stops being polled/placed) instead of
        failing the whole session; `stats()["placement"]` lists it."""
        live = self._live()
        if not live:
            return []
        if self._pool is None or len(live) == 1:
            results = [self._poll_group(g, timeout_s) for g in live]
        else:
            # every group's chunk (and its journal commit) ends before
            # this call returns or raises; the first error in gid order
            # is raised after (the reference's `pool.map` re-raises
            # group 0's crash while group 1's chunk may still be
            # committing: ROADMAP Queue 3)
            futures = [self._pool.submit(self._poll_group, g, timeout_s)
                       for g in live]
            wait(futures)
            results = [f.result() for f in futures]
        events: list = []
        for gid, evs, wedge in sorted(results, key=lambda r: r[0]):
            for handle, toks, done in evs:
                if getattr(handle, "group", None) is None:
                    handle.group = gid
                events.append((handle, toks, done))
            if wedge is not None:
                self.mesh.quarantine_group(gid)
        return events

    @property
    def busy(self) -> bool:
        """True while any live group has queued/running work or pending
        terminal events."""
        return any(g.session.busy for g in self._live())

    def stream(self, timeout_s: float | None = None) -> Iterator:
        """Yield combined events until every live group runs dry.
        Submitting more work mid-stream extends it."""
        while self.busy:
            yield from self.poll(timeout_s)

    def drain(self, timeout_s: float | None = None) -> dict:
        """Run until every live group completes its submitted requests;
        returns `stats()`. Quarantined groups are excluded — their
        in-flight work resumes after `recover_group`."""
        for _ in self.stream(timeout_s):
            pass
        return self.stats()

    def drain_group(self, gid: int, timeout_s: float | None = None) -> dict:
        """Stop placing into group `gid`, run it dry, and leave it
        draining (call `undrain_group` to return it to rotation).
        Returns the group's stats."""
        self.mesh.drain_group(gid)
        g = self.groups[gid]
        with g.on_device():
            while g.session.busy:
                g.session.poll(timeout_s)
        return g.session.stats()

    def undrain_group(self, gid: int) -> None:
        self.mesh.undrain_group(gid)

    def recover_group(self, gid: int) -> None:
        """Recover a quarantined group's wedged session and return it to
        placement rotation."""
        g = self.groups[gid]
        if getattr(g.session, "_wedged", False):
            with g.on_device():
                g.session.recover_wedged()
        self.mesh.recover_group(gid)

    # -- durability ------------------------------------------------------
    @property
    def recovered(self) -> dict:
        """Terminal requests rebuilt from the journals at restore time.
        One group: the group's `{rid: handle}` map unchanged (drop-in
        for `ServeSession.recovered`); several: keyed `(gid, rid)`."""
        if len(self.groups) == 1:
            return self.groups[0].session.recovered
        out = {}
        for g in self.groups:
            for rid, h in g.session.recovered.items():
                out[(g.gid, rid)] = h
        return out

    def handle(self, gid: int, rid: int):
        return self.groups[gid].session.handle(rid)

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate serving stats plus the per-group breakdown.

        Counters sum across groups; `tokens_per_s` is the sum of the
        groups' windowed rates (they run concurrently; on one card the
        sum is not the card's throughput); `occupancy_pct` is
        slot-weighted; `stall` is the `StallClock.merge` roll-up of the
        per-group ledgers (one shared wall, counters summed);
        `placement` is the mesh scheduler's ledger; `groups` maps gid to
        that group's full `ServeSession.stats()`.
        """
        per = {g.gid: g.session.stats() for g in self.groups}
        slots = sum(st["slots"] for st in per.values())
        occ = sum(st["occupancy_pct"] * st["slots"] for st in per.values())
        out = {
            "n_groups": len(self.groups),
            "requests_done": sum(st["requests_done"] for st in per.values()),
            "requests_failed": sum(st["requests_failed"]
                                   for st in per.values()),
            "requests_cancelled": sum(st["requests_cancelled"]
                                      for st in per.values()),
            "requests_shed": sum(st["requests_shed"] for st in per.values()),
            "emitted_total": sum(st["emitted_total"] for st in per.values()),
            "tokens_per_s": sum(st["tokens_per_s"] for st in per.values()),
            "occupancy_pct": occ / max(slots, 1),
            "slots": slots,
            "usable_slots": sum(st["usable_slots"] for st in per.values()),
            "queue_peak": max(st["queue_peak"] for st in per.values()),
            "ttft_ms": _pooled_pct(
                [getattr(g.session, "_ttfts", []) for g in self.groups]),
            "latency_ms": _pooled_pct(
                [getattr(g.session, "_latencies", [])
                 for g in self.groups]),
            "stall": StallClock.merge(
                [g.session.clock for g in self.groups]).report(),
            "placement": self.mesh.stats(),
            "groups": per,
        }
        kv_rows = [st["kv"] for st in per.values() if "kv" in st]
        if kv_rows:
            agg = {}
            for key in ("n_pages", "used_pages", "free_pages", "allocs",
                        "alloc_failures", "pages_shared", "cow_forks",
                        "prefix_hits", "prefix_misses", "evictions",
                        "prefill_skipped_tokens", "pool_exhausted"):
                vals = [kv.get(key) for kv in kv_rows if key in kv]
                if vals:
                    agg[key] = type(vals[0])(sum(vals))
            agg["page_size"] = kv_rows[0].get("page_size")
            if agg.get("n_pages"):
                agg["occupancy_pct"] = (100.0 * agg["used_pages"]
                                        / agg["n_pages"])
            out["kv"] = agg
        return out

    def close(self) -> None:
        for g in self.groups:
            g.session.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

"""repro_torch's serving groups against the reference's
(`repro.runtime.groups`, `repro.cluster.session.ShardedServeSessionProgram`).

* `MeshScheduler`: one seeded stream of `GroupView`s with quarantine,
  drain and recovery events gives equal scores (`==`), placements,
  rejections and `stats()` in both packages; the placement invariants of
  the reference's tests (one group a request, quarantined and draining
  groups get nothing, cold placement balances, warm overlap attracts).
* `StallClock.merge` and `SlotScheduler.load_view` equal the reference's
  on the same scripted operations.
* `GroupPlan` and `cells.group_devices` compare devices by value: two
  `torch.device("cuda", 0)` are one card, so the plan is degraded.
* `ShardedServeSession` on `qwen3-14b-smoke` (paged, pages of 4 tokens):
  `groups=1` is bit-identical to the port's plain session (tokens and kv
  counters); `groups=3` gives the reference's tokens, `handle.group`,
  `stats()["placement"]`, counters and key set; a wedged group is
  quarantined and recovered, cancel routes to the placed group,
  `drain_group` runs one group dry, the stats roll up, events equal the
  reference's poll by poll; the durable root's manifest guards both
  ways, a root written by either package is accepted (and its terminal
  requests recovered) by the other; a crash restart at `groups=1` and at
  `groups=2` delivers every token once; on one device the groups share
  the parameter tensors; `run()` is not defined.
* `examples/serve_sharded_torch.py` and `examples/locality_pipeline_torch.py`
  run on the CPU; the latter's histogram equalization equals the
  reference's on the same image.

Tolerance: none (scores, tokens and counters equal). Data: seeded numpy
streams and prompts; the reference's parameters in f32 on both sides,
caches cast to f32 (`torch_parity.f32_state_factory`);
`retry_backoff_s=0`; `watchdog_s=0.5` (only the scripted wedge reaches
it).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.session import Cluster as JCluster
from repro.cluster.session import ServeSessionProgram as JSession
from repro.cluster.session import ShardedServeSessionProgram as JSharded
from repro.runtime import engine as jengine
from repro.runtime import faults as jfaults
from repro.runtime import groups as jgroups
from repro.runtime import journal as jjournal
from repro.runtime import scheduler as jsched
from repro_torch import weights
from repro_torch.cluster import cells
from repro_torch.cluster.session import Cluster as TCluster
from repro_torch.cluster.session import ServeSessionProgram as TSession
from repro_torch.cluster.session import ShardedServeSessionProgram as TSharded
from repro_torch.runtime import engine as tengine
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import groups as tgroups
from repro_torch.runtime import journal as tjournal
from repro_torch.runtime import scheduler as tsched
from torch_parity import counters, f32_state_factory

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-14b-smoke"
PKG = {"ref": (jgroups, jsched, jfaults, jjournal),
       "port": (tgroups, tsched, tfaults, tjournal)}


# ----------------------------------------------------------------------------
# MeshScheduler, StallClock.merge, load_view, GroupPlan
# ----------------------------------------------------------------------------

def _view(mod, gid, *, free=2, queued=0, usable=2, max_queue=4, overlap=0):
    return mod.GroupView(gid=gid, free_slots=free, queued=queued,
                         usable_slots=usable, max_queue=max_queue,
                         overlap_pages=overlap)


def _mesh_script(mod, seed, n_groups):
    """A seeded stream of placements over random views, with quarantine,
    drain and recovery events; returns everything observable."""
    rng = np.random.default_rng(seed)
    ms = mod.MeshScheduler(n_groups, page_size=int(rng.integers(1, 17)))
    out = []
    for _ in range(60):
        op = rng.random()
        gid = int(rng.integers(0, n_groups))
        if op < 0.08:
            ms.quarantine_group(gid)
        elif op < 0.14:
            ms.recover_group(gid)
        elif op < 0.2:
            ms.drain_group(gid)
        elif op < 0.26:
            ms.undrain_group(gid)
        views = []
        for g in range(n_groups):
            usable = int(rng.integers(0, 5))
            mq = None if rng.random() < 0.3 else int(rng.integers(1, 6))
            views.append(_view(
                mod, g, free=int(rng.integers(0, usable + 1)),
                queued=int(rng.integers(0, 7)), usable=usable, max_queue=mq,
                overlap=int(rng.integers(0, 4)) if rng.random() < 0.4
                else 0))
        prompt = int(rng.integers(0, 70))
        out.append([ms.score(v, prompt) for v in views])
        out.append([ms.eligible(v) for v in views])
        try:
            out.append(("placed", ms.place(views, prompt_tokens=prompt)))
        except mod.QueueFull as e:
            out.append(("full", str(e)))
        out.append(ms.stats())
    return out


@pytest.mark.parametrize("n_groups", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_scheduler_equals_reference(seed, n_groups):
    assert _mesh_script(tgroups, seed, n_groups) == \
        _mesh_script(jgroups, seed, n_groups)


def test_placement_invariants():
    """The reference's invariants on the port: one group a request, a
    quarantined or draining group gets nothing, nothing eligible raises
    QueueFull, cold placement balances, warm overlap attracts, the score
    falls with overlap and rises with load, gids are checked."""
    ms = tgroups.MeshScheduler(3, page_size=4)
    ms.quarantine_group(2)
    running = [0, 0, 0]
    for _ in range(12):
        views = [_view(tgroups, g, free=max(2 - running[g], 0),
                       queued=max(running[g] - 2, 0)) for g in range(3)]
        try:
            gid = ms.place(views, prompt_tokens=4)
        except tsched.QueueFull:
            assert not any(ms.eligible(v) for v in views)
            continue
        running[gid] += 1
    assert sum(ms.placed) == ms.placements and ms.placed[2] == 0
    cold = tgroups.MeshScheduler(3, page_size=4)
    for _ in range(9):
        cold.place([_view(tgroups, g) for g in range(3)], prompt_tokens=4)
    assert cold.placed == [3, 3, 3]
    warm = tgroups.MeshScheduler(4, page_size=4)
    views = [_view(tgroups, g, overlap=2 if g == 3 else 0) for g in range(4)]
    assert warm.place(views, prompt_tokens=9) == 3
    assert warm.locality_hits == 1
    idle = warm.score(_view(tgroups, 0), 8)
    assert warm.score(_view(tgroups, 0, free=0, queued=3), 8) > idle > \
        warm.score(_view(tgroups, 0, overlap=2), 8)
    d = tgroups.MeshScheduler(2, page_size=4)
    d.drain_group(0)
    d.drain_group(1)
    with pytest.raises(tsched.QueueFull):
        d.place([_view(tgroups, 0), _view(tgroups, 1)])
    with pytest.raises(ValueError):
        d.quarantine_group(2)
    with pytest.raises(ValueError):
        tgroups.MeshScheduler(0)


def test_stall_merge_and_load_view_equal_reference():
    clocks = {}
    for name, mod in (("ref", jengine), ("port", tengine)):
        a, b = mod.StallClock(), mod.StallClock()
        a.host_syncs, a.dispatch_gap_s, a.device_wait_s = 3, 0.2, 0.1
        b.host_syncs, b.dispatch_gap_s, b.device_wait_s = 5, 0.3, 0.4
        a._t_start, b._t_start = 10.0, 9.5
        a._last_sync_end, b._last_sync_end = 11.0, None
        m = mod.StallClock.merge([a, b])
        e = mod.StallClock.merge([])
        clocks[name] = (m.host_syncs, m.dispatch_gap_s, m.device_wait_s,
                        m._t_start, m._last_sync_end, e.host_syncs,
                        e.dispatch_gap_s, e._last_sync_end,
                        e.report()["stall_pct"],
                        mod.StallClock.merge([b])._last_sync_end)
    assert clocks["port"] == clocks["ref"]
    views = {}
    for name, mod in (("ref", jsched), ("port", tsched)):
        s = mod.SlotScheduler(4, max_queue=3)
        out = [s.load_view()]
        for n, klass in ((3, "latency"), (1, "throughput"), (4, "latency"),
                         (2, "best_effort"), (5, "throughput"), (6, "latency")):
            s.submit(np.arange(n, dtype=np.int32), 4, klass=klass)
        out.append(s.load_view())
        s.admit(now=1e9)
        out.append(s.load_view())
        s.release(1)
        s.quarantine(1)
        out.append(s.load_view())
        views[name] = out
    assert views["port"] == views["ref"]


def test_group_plan_compares_devices_by_value():
    plan = tgroups.GroupPlan.build(4, devices=["d0", "d1"])
    assert plan.devices == ("d0", "d1", "d0", "d1") and plan.degraded
    assert not tgroups.GroupPlan.build(2, devices=["d0", "d1"]).degraded
    with pytest.raises(ValueError):
        tgroups.GroupPlan.build(0)
    # two device objects naming one card are one card
    one_card = (torch.device("cuda", 0), torch.device("cuda", 0))
    assert one_card[0] is not one_card[1]
    assert tgroups.GroupPlan(2, one_card).degraded
    assert not tgroups.GroupPlan(
        2, (torch.device("cuda", 0), torch.device("cuda", 1))).degraded
    assert cells.group_devices(["cpu", torch.device("cpu")], 3) == (
        torch.device("cpu"),) * 3
    cl = TCluster(ARCH, device="cpu")
    assert cells.group_devices(cl, 2) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        cells.group_devices(cl, 0)
    if not torch.cuda.is_available():
        assert tgroups.GroupPlan.build(2).devices == ()
        with pytest.raises(RuntimeError, match="CUDA"):
            cells.group_devices(None, 2)


# ----------------------------------------------------------------------------
# the sharded session on qwen3-14b-smoke, both packages
# ----------------------------------------------------------------------------

SPEC = dict(slots=2, max_seq=24, max_prompt=12, chunk=4, paged=True,
            page_size=4, retry_backoff_s=0.0, watchdog_s=0.5)


def _requests(n=8, seed=5):
    """Prompts of 2..12 tokens, half opening with one 8-token preamble
    (two pages), 3..8 new tokens."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, 200, 8)
    out = []
    for i in range(n):
        prompt = (np.concatenate([pre, rng.integers(1, 200, 2)]) if i % 2
                  else rng.integers(1, 200, int(rng.integers(2, 9))))
        out.append((prompt.astype(np.int32), int(rng.integers(3, 9))))
    return out


@pytest.fixture(scope="module")
def progs():
    """Both packages' programs for groups 1, 2, 3 and the plain session,
    caches in f32, and the reference's f32 parameters in both."""
    jcl, tcl = JCluster(ARCH), TCluster(ARCH, device="cpu")
    out = {"ref": {}, "port": {}}
    for name, cl, plain, sharded in (("ref", jcl, JSession, JSharded),
                                     ("port", tcl, TSession, TSharded)):
        out[name]["plain"] = f32_state_factory(cl.compile(plain(**SPEC)))
        for g in (1, 2, 3):
            out[name][g] = f32_state_factory(cl.compile(
                sharded(groups=g, **SPEC)))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      out["ref"]["plain"].init_params())
    out["ref"]["params"] = jp
    out["port"]["params"] = weights.from_jax_params(
        jax.tree.map(np.asarray, jp), device="cpu")
    return out


def _drive(sess, arrivals: dict):
    """`arrivals` maps a poll index to the requests submitted just before
    it. Returns (per-poll events [(group, rid, tokens, done)], handles in
    submit order)."""
    events, handles, i = [], [], 0
    last = max(arrivals, default=0)
    while i <= last or sess.busy:
        for prompt, n in arrivals.get(i, ()):
            handles.append(sess.submit(prompt, n))
        i += 1
        events.append([(h.group, h.id, np.asarray(t).tolist(), bool(d))
                       for h, t, d in sess.poll()])
    return events, handles


def _key_paths(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + str(k))
        if isinstance(v, dict) and k != "by_kind":
            out |= _key_paths(v, prefix + str(k) + ".")
    return out


def _groups_keys_only(stats):
    """`stats()` with every group's id turned to a string, so that key
    paths and counters of both packages line up."""
    return dict(stats, groups={str(k): v for k, v in
                               stats["groups"].items()})


def test_one_group_bit_identical_to_plain_session(progs):
    p = progs["port"]
    plain = p["plain"].open(params=p["params"])
    sh = p[1].open(params=p["params"])
    reqs = _requests()
    hp = [plain.submit(q, n) for q, n in reqs]
    hs = [sh.submit(q, n) for q, n in reqs]
    plain_stats, sh_stats = plain.drain(), sh.drain()
    for a, b in zip(hp, hs):
        assert np.array_equal(a.tokens, b.tokens) and b.group == 0
    rolled = {k: v for k, v in sh_stats["kv"].items()
              if k != "occupancy_pct"}       # the roll-up's own: used / n
    assert rolled == {k: plain_stats["kv"][k] for k in rolled}
    assert sh_stats["groups"][0]["kv"] == plain_stats["kv"]
    assert isinstance(sh.recovered, dict)
    assert not sh.plan.degraded
    plain.close()
    sh.close()


def test_three_groups_equal_reference(progs):
    """Two waves of requests (the second after the first drained, so its
    preamble sharers find warm pages): the same events poll by poll, the
    same placements, counters and stats keys."""
    reqs = _requests(12)
    got = {}
    for name in ("ref", "port"):
        sess = progs[name][3].open(params=progs[name]["params"])
        ev1, h1 = _drive(sess, {0: reqs[:6]})
        ev2, h2 = _drive(sess, {0: reqs[6:9], 2: reqs[9:]})
        st = sess.stats()
        got[name] = (ev1, ev2, [(h.group, h.id, h.tokens.tolist())
                                for h in h1 + h2],
                     st["placement"], counters(_groups_keys_only(st)),
                     _key_paths(st))
        sess.close()
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    assert got["port"][2] == got["ref"][2]
    assert got["port"][3] == got["ref"][3]
    assert got["port"][3]["locality_hits"] > 0
    assert sorted(set(g for g, *_ in got["port"][2])) == [0, 1, 2]
    assert got["port"][4] == got["ref"][4]
    assert got["port"][5] == got["ref"][5]


def test_groups_share_parameters_on_one_device(progs):
    p = progs["port"]
    sh = p[3].open(params=p["params"])
    assert sh.plan.degraded and sh.plan.devices == (torch.device("cpu"),) * 3
    first = [t.data_ptr() for t in weights_leaves(sh.groups[0].session)]
    for g in sh.groups[1:]:
        assert [t.data_ptr() for t in weights_leaves(g.session)] == first
        # each group's state is its own
        assert g.session.state["tok"].data_ptr() != \
            sh.groups[0].session.state["tok"].data_ptr()
    sh.close()


def weights_leaves(session):
    from repro_torch.runtime.compile_cache import tensor_leaves
    return list(tensor_leaves(session.params))


def test_wedged_group_quarantines_and_recovers_like_reference(progs):
    reqs = _requests(4)
    got = {}
    for name in ("ref", "port"):
        groups, _, faults, _ = PKG[name]
        sess = progs[name][2].open(
            params=progs[name]["params"],
            faults=[None, faults.FaultPlan().wedge(at_chunk=0)])
        hs = [sess.submit(q, n) for q, n in reqs[:2]]
        assert [h.group for h in hs] == [0, 1]
        events = []
        for _ in range(60):
            events.append([(h.group, h.id, np.asarray(t).tolist(), d)
                           for h, t, d in sess.poll()])
            if not sess.busy:
                break
        quarantined = sess.mesh.stats()["quarantined_groups"]
        done_groups = sorted({h.group for h in hs if h.done})
        h2 = sess.submit(*reqs[2])
        sess.recover_group(1)
        after = sess.mesh.stats()["quarantined_groups"]
        sess.drain()
        got[name] = (events, quarantined, done_groups, h2.group, after,
                     [h.tokens.tolist() for h in hs + [h2]],
                     all(h.done for h in hs + [h2]),
                     counters(_groups_keys_only(sess.stats())))
        sess.close()
    assert got["port"] == got["ref"]
    assert got["port"][1] == [1] and got["port"][2] == [0]
    assert got["port"][3] == 0 and got["port"][4] == [] and got["port"][6]


def test_cancel_drain_group_and_roll_up_like_reference(progs):
    reqs = _requests(6)
    got = {}
    for name in ("ref", "port"):
        sess = progs[name][2].open(params=progs[name]["params"])
        hc = sess.submit(*reqs[0])
        cancelled = sess.cancel(hc)
        hs = [sess.submit(q, n) for q, n in reqs[1:5]]
        gid = hs[0].group
        gst = sess.drain_group(gid)
        dry = all(h.done for h in hs if h.group == gid)
        h2 = sess.submit(*reqs[5])
        sess.undrain_group(gid)
        st = sess.drain()
        got[name] = (cancelled, hc.cancelled, gid, dry, h2.group != gid,
                     [h.tokens.tolist() for h in hs + [h2]],
                     counters(gst), counters(_groups_keys_only(st)))
        assert st["emitted_total"] == sum(
            g["emitted_total"] for g in st["groups"].values())
        assert st["slots"] == sum(g["slots"] for g in st["groups"].values())
        assert st["stall"]["host_syncs"] == sum(
            g["stall"]["host_syncs"] for g in st["groups"].values())
        assert 0.0 <= st["stall"]["stall_pct"] <= 100.0 * 2 + 1e-6
        sess.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] and got["port"][1] and got["port"][3]


def test_run_is_not_defined_and_groups_checked(progs):
    with pytest.raises(NotImplementedError):
        progs["port"][2].run()
    with pytest.raises(ValueError):
        TCluster(ARCH, device="cpu").compile(TSharded(groups=0, **SPEC))
    with pytest.raises(ValueError):
        progs["port"][2].open(params=progs["port"]["params"],
                              faults=[None, None, None])


# ----------------------------------------------------------------------------
# durability: manifests, cross-package roots, crash and restore
# ----------------------------------------------------------------------------

def test_manifest_guards_group_count(progs, tmp_path):
    p = progs["port"]
    d = tmp_path / "one"
    p[1].open(params=p["params"], durable_dir=d).close()
    assert json.loads((d / "manifest.json").read_text()) == {
        "kind": "repro-sharded-serve", "version": 1, "groups": 1}
    with pytest.raises(ValueError, match="groups=1"):
        p[2].open(params=p["params"], durable_dir=d, resume=True)
    # a plain session's manifest-less dir: only groups=1 adopts it
    plain = tmp_path / "plain"
    p["plain"].open(params=p["params"], durable_dir=plain).close()
    with pytest.raises(ValueError, match="no manifest.json"):
        p[2].open(params=p["params"], durable_dir=plain, resume=True)
    p[1].open(params=p["params"], durable_dir=plain, resume=True).close()
    two = tmp_path / "two"
    p[2].open(params=p["params"], durable_dir=two).close()
    assert sorted(x.name for x in two.iterdir()) == [
        "group00", "group01", "manifest.json"]


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_durable_root_crosses_packages(progs, tmp_path, writer, reader):
    """A root written by one package (journal only, every request
    finished) is accepted by the other's guard at the same group count
    and refused at another; its journals carry their group tags; the
    reader's restore recovers the writer's terminal requests."""
    reqs = _requests(5)
    d = tmp_path / "root"
    w = progs[writer][2].open(params=progs[writer]["params"], durable_dir=d)
    hs = [w.submit(q, n) for q, n in reqs]
    w.drain()
    want = {(h.group, h.id): h.tokens.tolist() for h in hs}
    w.close()
    journal = PKG[reader][3]
    for g in (0, 1):
        evs = journal.read_events(d / f"group{g:02d}" / "journal.jsonl")
        assert evs and all(e.get("group") == g for e in evs)
    with pytest.raises(ValueError, match="groups=2"):
        progs[reader][3].open(params=progs[reader]["params"],
                              durable_dir=d, resume=True)
    r = progs[reader][2].restore(d, params=progs[reader]["params"])
    got = {k: np.asarray(h.tokens).tolist()
           for k, h in r.recovered.items()}
    assert got == want
    assert not r.busy
    r.close()


def _crash_run(prog, params, faults_mod, d, crash_at, reqs):
    sess = prog.open(params=params, durable_dir=d,
                     faults=faults_mod.FaultPlan().crash(at_chunk=crash_at))
    hs = [sess.submit(q, n) for q, n in reqs]
    delivered = {}
    with pytest.raises(faults_mod.SessionCrashed):
        for _ in range(200):
            for h, toks, _ in sess.poll():
                delivered.setdefault((h.group, h.id), []).extend(
                    int(t) for t in toks)
            if not sess.busy:
                break
    return hs, delivered


@pytest.mark.parametrize("groups", [1, 2])
def test_crash_restart_delivers_exactly_once(progs, tmp_path, groups):
    """Crash a sharded session mid-flight (group 0's scripted crash),
    restore it from its root and stream the rest: the tokens delivered
    before the crash are journal-committed, and committed plus
    post-restore tokens equal the uncrashed run's, every token once."""
    p = progs["port"]
    reqs = _requests(6)
    ref = p[groups].open(params=p["params"])
    hr = [ref.submit(q, n) for q, n in reqs]
    ref.drain()
    want = {(h.group, h.id): h.tokens.tolist() for h in hr}
    ref.close()
    d = tmp_path / "crash"
    _, delivered = _crash_run(p[groups], p["params"], tfaults, d, 2, reqs)
    dirs = [d] if groups == 1 else [d / f"group{g:02d}"
                                    for g in range(groups)]
    committed = {}
    for g, gd in enumerate(dirs):
        evs = tjournal.read_events(gd / "journal.jsonl")
        assert all(e.get("group") == g for e in evs)
        for rid, r in tjournal.replay(evs).requests.items():
            committed[(g, rid)] = list(r.committed)
    for key, toks in delivered.items():
        assert committed[key][:len(toks)] == toks
    restored = p[groups].restore(d, params=p["params"])
    final = {k: list(v) for k, v in committed.items()}
    for h, toks, _ in restored.stream():
        final.setdefault((h.group, h.id), []).extend(int(t) for t in toks)
    assert final == want
    restored.close()


def test_crash_waits_for_every_group_before_raising(progs, tmp_path):
    """The crash race made deterministic: in the round where group 0's
    scripted crash raises, group 1's poll is held until group 0's has
    raised and then runs its chunk (and its journal commit) late. `poll`
    must not raise before group 1's chunk is over: no journal changes
    after it raised, and the restart delivers every token once (what
    `test_crash_restart_delivers_exactly_once[2]` checks, which this
    race failed under load)."""
    import threading
    import time
    p = progs["port"]
    reqs = _requests(6)
    ref = p[2].open(params=p["params"])
    hr = [ref.submit(q, n) for q, n in reqs]
    ref.drain()
    want = {(h.group, h.id): h.tokens.tolist() for h in hr}
    ref.close()
    d = tmp_path / "crash"
    sess = p[2].open(params=p["params"], durable_dir=d,
                     faults=tfaults.FaultPlan().crash(at_chunk=2))
    g0, g1 = (g.session for g in sess.groups)
    first_done = threading.Event()
    poll0, poll1 = g0.poll, g1.poll

    def held0(*a, **k):
        try:
            return poll0(*a, **k)
        finally:
            first_done.set()

    def held1(*a, **k):
        assert first_done.wait(10.0)
        first_done.clear()
        time.sleep(0.3)                 # group 0 has raised by now
        return poll1(*a, **k)

    g0.poll, g1.poll = held0, held1
    hs = [sess.submit(q, n) for q, n in reqs]
    assert {h.group for h in hs} == {0, 1}
    delivered = {}
    with pytest.raises(tfaults.SessionCrashed):
        for _ in range(200):
            for h, toks, _ in sess.poll():
                delivered.setdefault((h.group, h.id), []).extend(
                    int(t) for t in toks)
    journals = [d / f"group{g:02d}" / "journal.jsonl" for g in (0, 1)]
    at_raise = [j.read_bytes() for j in journals]
    time.sleep(0.6)
    assert [j.read_bytes() for j in journals] == at_raise
    committed = {}
    for g, j in enumerate(journals):
        for rid, r in tjournal.replay(
                tjournal.read_events(j)).requests.items():
            committed[(g, rid)] = list(r.committed)
    for key, toks in delivered.items():
        assert committed[key][:len(toks)] == toks
    restored = p[2].restore(d, params=p["params"])
    final = {k: list(v) for k, v in committed.items()}
    for h, toks, _ in restored.stream():
        final.setdefault((h.group, h.id), []).extend(int(t) for t in toks)
    assert final == want
    restored.close()


# ----------------------------------------------------------------------------
# the examples
# ----------------------------------------------------------------------------

def _example(name):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_serve_sharded_example_on_cpu(capsys):
    ex = _example("serve_sharded_torch")
    st = ex.main(["--device", "cpu", "--groups", "2", "--requests", "8",
                  "--rate", "1000"])
    out = capsys.readouterr().out
    assert st["requests_done"] == 9 and st["n_groups"] == 2
    assert st["delivered"] == st["emitted_total"] - 2       # warm-up's 2
    assert "locality rate" in out and "placement:" in out
    assert st["placement"]["placements"] == 9


def test_locality_pipeline_example_on_cpu(capsys):
    from repro.cluster.session import Cluster as JKernelCluster  # noqa: F401
    jex = _example("locality_pipeline")
    ex = _example("locality_pipeline_torch")
    out = ex.main(["--device", "cpu", "--size", "64"])
    img = out["image"].numpy()
    want = np.asarray(jax.jit(jex.histogram_equalization)(jnp.asarray(img)))
    np.testing.assert_array_equal(out["equalized"].numpy(), want)
    from repro_torch.kernels.conv2d import conv2d_3x3_plain
    torch.testing.assert_close(out["smoothed"],
                               conv2d_3x3_plain(out["conv_input"],
                                                out["weights"]),
                               rtol=0, atol=0)
    from repro.core.interconnect import TOP_H, TopologyModel
    m = TopologyModel(TOP_H)
    for phase, p_local in ex.PHASES:
        assert out["model"][phase] == (m.avg_latency(0.3, p_local=p_local),
                                       m.accepted_load(1.0, p_local=p_local))
    assert "histogram equalization" in capsys.readouterr().out

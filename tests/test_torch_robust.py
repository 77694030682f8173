"""repro_torch's robustness layer against the reference's
(`repro.runtime.faults`, `scheduler`, the session's fault paths).

* `FaultPlan`: the same scripts fire the same faults in the same order
  and give the same `summary()`, `exhausted` and `pending_wedge`;
  malformed faults raise in both.
* `SlotScheduler`: one seeded stream of submit, admit, release, requeue,
  quarantine and preemption queries, for each class mix and admission
  policy, gives the same admissions, sheds, victims and queue views.
  Shedding is compared with what the reference does, not with a
  property: the reference's own shedding test fails.
  `serialize_request` dicts cross the packages both ways.
* The paged session (`qwen3-14b-smoke`, 4 slots, pages of 4 tokens)
  under each fault kind, and all of them at once: the same events poll
  by poll, the same tokens and the same `stats()` counters (timings
  aside) with the reference's key set.
* The private session (`xlstm-125m-smoke`, `recurrentgemma-9b-smoke`:
  cache groups and recurrent state) with preemption, `kill_slot` and
  `corrupt_nan`: the same events, tokens and counters as the reference,
  and the preempted and restarted requests' tokens equal to a fault-free
  run's.

Tolerance: none, tokens and counters are equal. Data: prompts and
lengths from seeded numpy generators; parameters are the reference's,
cast to f32 with the caches (`torch_parity.f32_state_factory`, which
also covers the states `recover_wedged` rebuilds), the recurrent archs'
with their agreed test data (`torch_parity.session_params`).
`retry_backoff_s=0` on both sides: the backoff gate reads the wall clock,
which would make admission timing-dependent. `watchdog_s=0.5` bounds the
device wait; only the scripted wedge reaches it.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.cluster.session import Cluster as JCluster
from repro.cluster.session import ServeSessionProgram as JSession
from repro.runtime import faults as jfaults
from repro.runtime import scheduler as jsched
from repro_torch import weights
from repro_torch.cluster.session import Cluster as TCluster
from repro_torch.cluster.session import ServeSessionProgram as TSession
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import scheduler as tsched
from torch_parity import (counters, drive, f32_state_factory, key_set,
                          session_params)

CLASSES = ("latency", "throughput", "throughput", "best_effort")


# ----------------------------------------------------------------------------
# FaultPlan
# ----------------------------------------------------------------------------

SCRIPTS = {
    "one_each": [("kill_slot", 2, 0), ("corrupt_nan", 4, 1), ("wedge", 6),
                 ("refill_error", 3), ("page_alloc_fail", 1),
                 ("bit_flip", 5), ("crash", 7)],
    "same_chunk": [("kill_slot", 2, 0), ("kill_slot", 2, 3),
                   ("corrupt_nan", 2, 1), ("refill_error", 2),
                   ("refill_error", 2)],
    "pages": [("bit_flip", 1), ("bit_flip", 1, None, 7), ("bit_flip", 3)],
}


def _plan(mod, script):
    plan = mod.FaultPlan()
    for kind, at, *rest in script:
        slot = rest[0] if rest else None
        page = rest[1] if len(rest) > 1 else None
        plan.add(kind, at, slot, page)
    return plan


def _consume(mod, plan, chunks=9):
    """Every session query at every chunk, in the session's order."""
    out = []
    for c in range(chunks):
        out.append(("flips", plan.bit_flips(c)))
        out.append(("alloc", plan.page_alloc_failed(c)))
        try:
            plan.check_refill(c)
            out.append(("refill", "ok"))
        except mod.InjectedFault as e:
            out.append(("refill", str(e)))
        out.append(("pending_wedge", plan.pending_wedge))
        out.append(("corrupts", plan.corrupts(c)))
        out.append(("wedged", plan.wedged(c)))
        out.append(("kills", plan.kills(c)))
        out.append(("crashed", plan.crashed(c)))
        out.append(("exhausted", plan.exhausted))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_fault_plan_matches_reference(name):
    jp, tp = _plan(jfaults, SCRIPTS[name]), _plan(tfaults, SCRIPTS[name])
    assert (tp.has_wedge, tp.has_corruption) == (jp.has_wedge,
                                                 jp.has_corruption)
    assert _consume(tfaults, tp) == _consume(jfaults, jp)
    assert tp.fired == jp.fired
    assert tp.summary() == jp.summary() and repr(tp) == repr(jp)
    assert tfaults.KINDS == jfaults.KINDS


@pytest.mark.parametrize("bad", [("nope", 1), ("kill_slot", 1),
                                 ("wedge", 1, 0), ("kill_slot", -1, 0),
                                 ("wedge", 1, None, 3)])
def test_fault_validation_matches_reference(bad):
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError):
            mod.Fault(*bad)


# ----------------------------------------------------------------------------
# SlotScheduler
# ----------------------------------------------------------------------------

MIXES = {"latency": ("latency",),
         "bulk": ("throughput", "best_effort"),
         "all": ("latency", "throughput", "best_effort")}


def _ops(mix, n=120, seed=0):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.45:
            ops.append(("submit", rng.integers(1, 50, int(rng.integers(
                1, 12))).astype(np.int32), int(rng.integers(1, 9)),
                mix[int(rng.integers(len(mix)))]))
        elif r < 0.65:
            ops.append(("admit",))
        elif r < 0.8:
            ops.append(("release", int(rng.integers(8)),
                        bool(rng.random() < 0.5)))
        elif r < 0.9:
            ops.append(("victim", int(rng.integers(3))))
        elif r < 0.95:
            ops.append(("quarantine", int(rng.integers(8))))
        else:
            ops.append(("cancel", int(rng.integers(40))))
    return ops


def _run_scheduler(mod, ops, **kw):
    """Apply `ops`; record every observable after each one."""
    sch = mod.SlotScheduler(6, **kw)
    reqs, log, now = {}, [], 0.0
    for op in ops:
        kind = op[0]
        if kind == "submit":
            try:
                req = sch.submit(op[1], op[2], klass=op[3])
                reqs[req.rid] = req
                log.append(("rid", req.rid, req.state))
            except mod.QueueFull:
                log.append(("full",))
        elif kind == "admit":
            now += 1.0
            log.append(("admit", [(s, r.rid) for s, r in sch.admit(now)]))
        elif kind == "release":
            running = list(sch.running_requests())
            if running:
                slot, req = running[op[1] % len(running)]
                sch.release(slot)
                if req.state == mod.RUNNING:
                    sch.requeue(req, front=op[2])
                log.append(("release", slot, req.rid))
        elif kind == "victim":
            v = sch.preempt_victim(for_rank=op[1])
            log.append(("victim", None if v is None else (v[0], v[1].rid)))
        elif kind == "quarantine":
            if op[1] in sch.free_slots():
                sch.quarantine(op[1])
        elif kind == "cancel" and op[1] in reqs:
            log.append(("cancel", sch.cancel(reqs[op[1]])))
        log.append(("view", sch.queued_by_class(), sch.quarantined,
                    sch.usable_slots, sch.running, sch.queue_peak,
                    [r.rid for r in sch.pop_shed()],
                    [r.rid for r in sch.queued_requests()]))
    return log, list(sch.admitted_order), dict(sch.shed_count)


@pytest.mark.parametrize("policy", ["fifo", "longest_prefix"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_scheduler_matches_reference(mix, policy):
    ops = _ops(MIXES[mix])
    kw = dict(policy=policy, shed_watermark=5, aging_rounds=3, max_queue=9)
    assert _run_scheduler(tsched, ops, **kw) == \
        _run_scheduler(jsched, ops, **kw)


def test_scheduler_prefix_score_matches_reference():
    """"longest_prefix" scored by a prefix function (the paged pool's
    `match_len`): the same order and `prefix_pages_expected`."""
    def score(prompt):
        return int(prompt[0]) % 3 * 4
    out = []
    for mod in (jsched, tsched):
        sch = mod.SlotScheduler(3, policy="longest_prefix",
                                prefix_score=score, page_size=4)
        rng = np.random.default_rng(4)
        reqs = [sch.submit(rng.integers(1, 30, int(rng.integers(1, 9))), 2,
                           klass=CLASSES[i % 4]) for i in range(9)]
        got = [(s, r.rid) for s, r in sch.admit(1.0)]
        out.append((got, [r.prefix_pages_expected for r in reqs]))
    assert out[0] == out[1]


def test_serialize_request_crosses_packages():
    """A request serialized by either package deserializes in the other
    to the same dict (the reference's keys)."""
    jreq = jsched.Request(rid=3, prompt=np.arange(1, 6, dtype=np.int32),
                          max_new=7, klass="throughput", deadline_s=0.5)
    jreq.tokens, jreq.retries, jreq.suppress_until = [4, 5], 1, 2
    jreq.state, jreq.slot = jsched.RUNNING, 2
    treq = tsched.deserialize_request(jsched.serialize_request(jreq))
    assert tsched.serialize_request(treq) == jsched.serialize_request(jreq)
    back = jsched.deserialize_request(tsched.serialize_request(treq))
    assert jsched.serialize_request(back) == tsched.serialize_request(treq)
    treq.snapshot = {"tok": 1}
    d = tsched.serialize_request(treq)
    assert d["had_snapshot"] and set(d) == set(
        jsched.serialize_request(jreq))


# ----------------------------------------------------------------------------
# sessions under faults
# ----------------------------------------------------------------------------

PAGED = dict(slots=4, max_seq=48, max_prompt=16, chunk=4, paged=True,
             page_size=4, watchdog_s=0.5, retry_backoff_s=0.0)
PAGED_FAULTS = {
    "kill_slot": [("kill_slot", 1, 0)],
    "corrupt_nan": [("corrupt_nan", 2, 1)],
    "wedge": [("wedge", 2)],
    "refill_error": [("refill_error", 3), ("refill_error", 6)],
    "page_alloc_fail": [("page_alloc_fail", 6)],
    "bit_flip": [("bit_flip", 5)],
    "all": [("kill_slot", 1, 0), ("corrupt_nan", 2, 1), ("refill_error", 3),
            ("page_alloc_fail", 4), ("bit_flip", 5), ("wedge", 6)],
}


def _paged_script():
    """Eight requests of the four classes cycled, half sharing a 12-token
    preamble (three pages, so later ones hit the prefix cache and the
    scrub has stamped pages to check), then four more after the third
    poll."""
    rng = np.random.default_rng(0)
    pre = rng.integers(1, 200, 12)

    def one(i):
        prompt = (np.concatenate([pre, rng.integers(1, 200, 3)]) if i % 2
                  else rng.integers(1, 200, 6))
        return prompt.astype(np.int32), int(rng.integers(4, 9)), \
            CLASSES[i % 4]
    return {0: [one(i) for i in range(8)], 3: [one(i) for i in range(8, 12)]}


@pytest.fixture(scope="module")
def paged_progs():
    jprog = f32_state_factory(JCluster("qwen3-14b-smoke").compile(
        JSession(**PAGED)))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jprog.init_params())
    tp = weights.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tprog = f32_state_factory(TCluster("qwen3-14b-smoke",
                                       device="cpu").compile(
        TSession(**PAGED)))
    return jprog, jp, tprog, tp


def _both(jprog, jp, tprog, tp, script, arrivals):
    jplan, tplan = _plan(jfaults, script), _plan(tfaults, script)
    jev, jh = drive(jprog.open(params=jp, faults=jplan), arrivals,
                    jfaults.SessionWedged)
    tsess = tprog.open(params=tp, faults=tplan)
    tev, th = drive(tsess, arrivals, tfaults.SessionWedged)
    jst = jprog._last_session.stats()
    return (jev, jh, jst, jplan), (tev, th, tsess.stats(), tplan)


@pytest.mark.parametrize("kind", sorted(PAGED_FAULTS))
def test_paged_session_faults_match_reference(paged_progs, kind):
    (jev, jh, jst, jplan), (tev, th, tst, tplan) = _both(
        *paged_progs, PAGED_FAULTS[kind], _paged_script())
    assert tplan.fired == jplan.fired and tplan.exhausted
    assert tev == jev
    assert {i: (h.state, h.tokens.tolist()) for i, h in th.items()} == \
        {i: (h.state, h.tokens.tolist()) for i, h in jh.items()}
    assert key_set(tst) == key_set(jst)
    assert counters(tst) == counters(jst)
    if kind == "bit_flip":      # the checksum, not the NaN scan, saw it
        assert tst["durability"]["integrity_violations"] == 1


def test_paged_faults_keep_fault_free_tokens(paged_progs):
    """Every request that completes under all the faults has the tokens
    of the fault-free run (the recovery contract), in the port."""
    _, _, tprog, tp = paged_progs
    arrivals = _paged_script()
    _, clean = drive(tprog.open(params=tp), arrivals)
    plan = _plan(tfaults, PAGED_FAULTS["all"])
    _, chaos = drive(tprog.open(params=tp, faults=plan), arrivals,
                     tfaults.SessionWedged)
    done = [i for i, h in chaos.items() if h.ok]
    assert len(done) == len(clean)
    for i in done:
        np.testing.assert_array_equal(chaos[i].tokens, clean[i].tokens)


PRIVATE = dict(slots=3, max_seq=40, max_prompt=10, chunk=4,
               watchdog_s=0.5, retry_backoff_s=0.0)


def _private_script():
    """Three bulk requests fill the three slots; two latency requests
    arrive after the first poll and preempt two of them, which resume
    later; a fourth bulk request queues behind."""
    rng = np.random.default_rng(8)

    def one(klass):
        return (rng.integers(1, 200, int(rng.integers(2, 10))).astype(
            np.int32), int(rng.integers(6, 14)), klass)
    return {0: [one("throughput"), one("best_effort"), one("throughput"),
                one("best_effort")],
            1: [one("latency"), one("latency")]}


@pytest.mark.parametrize("arch", ["xlstm-125m-smoke",
                                  "recurrentgemma-9b-smoke"],
                         ids=lambda a: a.split("-")[0])
def test_private_session_preempt_and_faults_match_reference(arch):
    jp, tp = session_params(arch, PRIVATE)
    jc, tc = JCluster(arch), TCluster(arch, device="cpu")
    with jc.policy("fused"):
        jprog = f32_state_factory(jc.compile(JSession(**PRIVATE)))
    with tc.policy("fused"):
        tprog = f32_state_factory(tc.compile(TSession(**PRIVATE)))
    script = [("kill_slot", 3, 1), ("corrupt_nan", 4, 0)]
    arrivals = _private_script()
    (jev, jh, jst, _), (tev, th, tst, tplan) = _both(
        jprog, jp, tprog, tp, script, arrivals)
    assert tev == jev
    assert counters(tst) == counters(jst) and key_set(tst) == key_set(jst)
    assert tst["preemptions"] >= 1 and tst["retries"] == 2
    assert tst["quarantined_slots"] == [1] and tplan.exhausted
    # preempted, killed and poisoned requests resume bit for bit
    _, clean = drive(tprog.open(params=tp), arrivals)
    assert all(h.ok for h in th.values())
    for i, h in th.items():
        np.testing.assert_array_equal(h.tokens, clean[i].tokens)


def test_shedding_matches_reference(paged_progs):
    """`shed_watermark` over a burst of mixed classes: the same requests
    shed (best-effort only, newest first), the same events and counters
    as the reference's session gives."""
    jprog0, jp, tprog0, tp = paged_progs
    spec = dict(PAGED, shed_watermark=3)
    jprog = f32_state_factory(JCluster("qwen3-14b-smoke").compile(
        JSession(**spec)))
    tprog = f32_state_factory(TCluster("qwen3-14b-smoke",
                                       device="cpu").compile(
        TSession(**spec)))
    arrivals = _paged_script()
    (jev, jh, jst, _), (tev, th, tst, _) = _both(jprog, jp, tprog, tp, [],
                                                 arrivals)
    assert tev == jev and counters(tst) == counters(jst)
    shed = sorted(i for i, h in th.items() if h.fail_reason == "shed")
    assert shed and shed == sorted(i for i, h in jh.items()
                                   if h.fail_reason == "shed")
    assert tst["requests_shed"] == len(shed)


def test_serve_chaos_example_on_cpu():
    """examples/serve_chaos_torch.py on the CPU: a kill, a NaN corruption
    and a wedge against a live session; every request completes with the
    fault-free run's tokens (exit code 0)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(root / "examples" / "serve_chaos_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=root)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "bit_identical=yes" in proc.stdout and "wedges=1" in proc.stdout

"""Chaos serving on the PyTorch port: scripted faults against a live
`repro_torch` ServeSession (the flow of `examples/serve_chaos.py`).

A Poisson arrival stream of mixed-priority requests runs twice through
the same compiled session cell, once fault-free and once under a
`FaultPlan` that kills a slot mid-decode (quarantine + requeue),
NaN-corrupts another slot's cache rows (the NaN scan + recycle +
requeue) and wedges a device wait (the watchdog -> `SessionWedged` ->
`recover_wedged()`). Every request that completes under chaos must have
the fault-free run's tokens, bit for bit; exit code 1 on any divergence.
Prints a `# chaos:` summary line.

    PYTHONPATH=src python examples/serve_chaos_torch.py --requests 16

`--crash` is the crash-restart drill: a child process serves the same
workload with the durability layer on (journal + periodic snapshots) and
SIGKILLs itself mid-decode; the parent checks the kill, restores a
session from the durable directory, drains it and requires the tokens
committed before the crash together with those delivered after the
restore to equal the fault-free run's: every token once, bit for bit.
Prints a `# chaos-crash:` line with the measured time to restore.

    PYTHONPATH=src python examples/serve_chaos_torch.py --crash

The session runs on the GPU; `--device cpu` runs it on the CPU.
"""

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.cluster.session import Cluster, ServeSessionProgram
from repro_torch.runtime import FaultPlan, SessionWedged
from repro_torch.runtime.journal import read_events, replay

CLASS_MIX = ("latency", "throughput", "throughput", "best_effort")


def run_workload(program, params, prompts, out_lens, arrivals, plan=None):
    """Drive one session over the workload; returns (handles, stats,
    wedge recoveries). A wedge raises `SessionWedged` mid-poll; the
    loop recovers and keeps serving."""
    session = program.open(params=params, faults=plan)
    handles = []
    wedges = 0
    t0 = time.perf_counter()
    next_up = 0
    n = len(prompts)
    while next_up < n or session.scheduler.busy:
        now = time.perf_counter() - t0
        while next_up < n and arrivals[next_up] <= now:
            handles.append(session.submit(
                prompts[next_up], int(out_lens[next_up]),
                klass=CLASS_MIX[next_up % len(CLASS_MIX)]))
            next_up += 1
        try:
            events = session.poll()
        except SessionWedged as e:
            print(f"  wedged at chunk {e.chunk} (watchdog "
                  f"{e.timeout_s:.2f}s) — rebuilding the pool")
            session.recover_wedged()
            wedges += 1
            continue
        if not events and next_up < n:
            time.sleep(min(0.005, max(arrivals[next_up] - now, 0.0)))
    return handles, session.stats(), wedges


def crash_setup(args):
    """The program and workload the drill's parent and its child share
    (both submit the same request stream, so journal rids line up)."""
    cluster = Cluster(args.arch + "-smoke", device=args.device)
    cfg = cluster.arch
    program = cluster.compile(ServeSessionProgram(
        slots=args.slots, max_seq=64, max_prompt=8, chunk=args.chunk,
        snapshot_every=3))
    params = program.init_params()
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(1, 9))
               .astype(np.int32) for _ in range(args.requests)]
    out_lens = rng.choice([8, 12, 16, 24], size=args.requests)
    return program, params, prompts, out_lens


def run_crash_child(args):
    """Serve with durability on and SIGKILL ourselves at the scripted
    chunk: only what the journal and the snapshots hold survives."""
    program, params, prompts, out_lens = crash_setup(args)
    plan = FaultPlan().crash(at_chunk=args.crash_at)
    sess = program.open(
        params=params, durable_dir=args.dir, faults=plan,
        crash_hook=lambda chunk: os.kill(os.getpid(), signal.SIGKILL))
    for p, n in zip(prompts, out_lens):
        sess.submit(p, int(n))
    sess.drain()        # never completes: the crash hook kills -9 first
    raise SystemExit("crash fault never fired — workload too short")


def run_crash_drill(args):
    """Parent side: fault-free run, SIGKILL'd child, restore + drain,
    exactly-once and bit-identical check."""
    program, params, prompts, out_lens = crash_setup(args)
    print("reference run (fault-free, in-process):")
    ref = program.open(params=params)
    ref_handles = [ref.submit(p, int(n))
                   for p, n in zip(prompts, out_lens)]
    ref.drain()
    expected = {h.id: [int(t) for t in h.result()] for h in ref_handles}
    print(f"  {len(expected)} done, "
          f"{sum(len(t) for t in expected.values())} tokens")

    with tempfile.TemporaryDirectory() as d:
        child_args = [sys.executable, __file__, "--crash-child",
                      "--dir", d, "--arch", args.arch,
                      "--slots", str(args.slots),
                      "--requests", str(args.requests),
                      "--chunk", str(args.chunk),
                      "--seed", str(args.seed),
                      "--crash-at", str(args.crash_at),
                      "--device", args.device]
        print(f"child run (SIGKILL at chunk {args.crash_at}):")
        proc = subprocess.run(child_args, env=dict(
            os.environ, PYTHONPATH=str(
                Path(__file__).resolve().parents[1] / "src")))
        if proc.returncode != -signal.SIGKILL:
            print(f"  child exited {proc.returncode}, expected "
                  f"{-signal.SIGKILL} (SIGKILL) — crash never fired")
            raise SystemExit(1)
        print(f"  child killed -9, journal + snapshots left in {d}")

        committed = {rid: list(r.committed) for rid, r in
                     replay(read_events(Path(d) / "journal.jsonl"))
                     .requests.items()}
        pre_crash = sum(len(t) for t in committed.values())
        sess = program.restore(d, params=params)
        du = sess.stats()["durability"]
        final = {rid: list(toks) for rid, toks in committed.items()}
        for h, toks, done in sess.stream():
            final.setdefault(h.id, []).extend(int(t) for t in toks)

        mismatches = dupes = 0
        for rid, want in expected.items():
            got = final.get(rid, [])
            if got != want:
                tag = ("over-delivered"
                       if got[:len(want)] == want else "DIVERGED")
                if tag == "over-delivered":
                    dupes += 1
                else:
                    mismatches += 1
                print(f"  req {rid}: {tag} "
                      f"({len(got)} vs {len(want)} tokens)")
        identical = "yes" if mismatches == 0 else "NO"
        exactly_once = "yes" if dupes == 0 else "NO"
        print(f"# chaos-crash: crash_at={args.crash_at} "
              f"committed_pre_crash={pre_crash} "
              f"replayed={du['replayed_requests']} "
              f"resubmitted={du['resubmitted']} "
              f"recovered_terminal={du['recovered_terminal']} "
              f"deduped={sess.stats()['durability']['deduped_tokens']} "
              f"snapshot_step={du['restored_step']} "
              f"mttr_ms={du['restore_s'] * 1e3:.1f} "
              f"bit_identical={identical} exactly_once={exactly_once}")
        sess.close()
        if mismatches or dupes:
            raise SystemExit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--device", default="cuda",
                    help="where the session runs (cuda, or cpu)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=40.0,
                    help="mean request arrivals per second (Poisson)")
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--watchdog", type=float, default=0.5,
                    help="per-chunk device-wait bound (seconds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash", action="store_true",
                    help="crash-restart drill: SIGKILL'd child + "
                         "journal/snapshot restore (see module docstring)")
    ap.add_argument("--crash-at", type=int, default=6,
                    help="chunk boundary the child crashes at")
    ap.add_argument("--crash-child", action="store_true",
                    help=argparse.SUPPRESS)       # internal: child mode
    ap.add_argument("--dir", default=None,
                    help=argparse.SUPPRESS)       # internal: durable dir
    args = ap.parse_args()

    if args.crash_child:
        run_crash_child(args)
        return
    if args.crash:
        run_crash_drill(args)
        return

    cluster = Cluster(args.arch + "-smoke", device=args.device)
    cfg = cluster.arch
    program = cluster.compile(ServeSessionProgram(
        slots=args.slots, max_seq=64, max_prompt=8, chunk=args.chunk,
        watchdog_s=args.watchdog, max_retries=3, retry_backoff_s=0.01))
    params = program.init_params()

    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(1, 9))
               .astype(np.int32) for _ in range(args.requests)]
    out_lens = rng.choice([8, 12, 16, 24, 32], size=args.requests)

    # one of each failure mode, spread over the run's chunk timeline
    plan = (FaultPlan()
            .kill_slot(at_chunk=3, slot=1)
            .corrupt_nan(at_chunk=5, slot=2)
            .wedge(at_chunk=8))

    print(f"arch={cfg.name} device={args.device} slots={args.slots} "
          f"chunk={args.chunk} — {args.requests} requests, ~{args.rate}/s "
          f"Poisson, faults: kill@3/slot1, nan@5/slot2, wedge@8")
    print("reference run (fault-free):")
    ref_handles, ref_stats, _ = run_workload(program, params, prompts,
                                             out_lens, arrivals)
    print(f"  {ref_stats['requests_done']} done, "
          f"{ref_stats['emitted_total']} tokens")
    print("chaos run:")
    handles, stats, wedges = run_workload(program, params, prompts,
                                          out_lens, arrivals, plan=plan)

    survivors = mismatches = 0
    for i, (h, ref) in enumerate(zip(handles, ref_handles)):
        if not h.ok:
            print(f"  req {i}: not completed under chaos "
                  f"({h.state}{': ' + h.fail_reason if h.fail_reason else ''})")
            continue
        survivors += 1
        if not (ref.ok and np.array_equal(h.tokens, ref.tokens)):
            mismatches += 1
            print(f"  req {i}: DIVERGED from the fault-free run "
                  f"({h.tokens.size} vs {ref.tokens.size} tokens)")

    fired = plan.summary()["by_kind"]
    identical = "yes" if mismatches == 0 else "NO"
    print(f"# chaos: kills={fired['kill_slot']} "
          f"corruptions={fired['corrupt_nan']} wedges={wedges} "
          f"refill_errors={fired['refill_error']} "
          f"retries={stats['retries']} preemptions={stats['preemptions']} "
          f"failed={stats['requests_failed']} "
          f"quarantined={len(stats['quarantined_slots'])} "
          f"survivors={survivors}/{args.requests} bit_identical={identical}")
    if mismatches or not plan.exhausted:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

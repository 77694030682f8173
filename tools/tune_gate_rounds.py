"""How often chip_smoke.py's tune gate (tuned <= default x 1.15) refuses a
cell, read at 3 rounds of its re-time and at `--rounds` (GPU).

For one tree (`--root`, a checkout or a `git archive` of one): build its
kernels, run its suite phase once (the phase before tune in a whole run),
then its tune phase `--runs` times. Each run's re-time takes `--rounds`
rounds (default 7) and keeps every round's time, so the 3-round verdict
is read from the first 3 rounds of the same run (a 3-round re-time is
exactly those rounds: the same warm-up burst, the same order). The
registry and the race results are cleared before each run, so each run
races again. A run the gate refuses at the tree's own rounds is recorded,
not fatal.

`--spin-cycles N` sets the spin the race's and the re-time's timers queue
before each timed launch (`pipeline.SPIN_CYCLES`; 0: none, as before
it existed; a tree without it ignores the option). `--stress N` keeps N
processes spinning on the host's cores from the end of the suite phase
(a host whose cores are shared) and stops them at the end.

    python3 tools/tune_gate_rounds.py --root . --runs 6 \
        --out results/tune_gate.json
    python3 tools/tune_gate_rounds.py --stress 8 --spin-cycles 0 \
        --runs 3 --out results/tune_gate_nospin.json

Prints one `[gate]` line a run and a summary with the card's name and
power limit; writes every cell's rounds to `--out`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

GATE = 1.15


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--spin-cycles", type=int, default=None)
    ap.add_argument("--stress", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import multiprocessing as mp
    spinners = [mp.get_context("spawn").Process(target=_spin, daemon=True)
                for _ in range(args.stress)]

    def stress():
        for p in spinners:
            p.start()
    try:
        return _measure(args, stress)
    finally:
        for p in spinners:
            if p.pid is not None:
                p.terminate()
                p.join()


def _spin() -> None:
    while True:
        pass


def _measure(args, stress) -> int:
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import torch

    import chip_smoke
    from repro_torch.configs import registry
    from repro_torch.kernels import build, launches
    from repro_torch.kernels import pipeline as pp

    print(chip_smoke.gpu_line(), flush=True)
    if args.spin_cycles is not None and hasattr(pp, "SPIN_CYCLES"):
        pp.SPIN_CYCLES = args.spin_cycles
    spin = getattr(pp, "SPIN_CYCLES", 0)
    build.build()
    chip_smoke.suite_phase(launches)
    stress()

    cells: list[dict] = []

    def recording(timer, winner, default, rounds=args.rounds):
        for _ in range(50):
            default()
        torch.cuda.synchronize()
        times = ([], [])
        for _ in range(rounds):
            for t, fn in zip(times, (default, winner)):
                t.append(timer(fn))
        at = sys._getframe(1).f_locals       # tune_phase's loop variables
        cells.append({"kernel": at.get("name"), "shape_key": at.get("key"),
                      "picked": at.get("picked"), "own_plan": at.get("own"),
                      "route": getattr(at.get("rec"), "route", None),
                      "default_ms": times[0], "tuned_ms": times[1]})
        return min(times[1]), min(times[0])

    chip_smoke._retime = recording
    runs = []
    for i in range(args.runs):
        registry.KERNEL_TUNES.clear()
        pp.TUNE_RESULTS.clear()
        cells.clear()
        t0 = time.perf_counter()
        error = None
        try:
            chip_smoke.tune_phase(launches)
        except AssertionError as e:
            error = str(e)
        for c in cells:
            c["equal_plans"] = (c["picked"] == c["own_plan"]
                                and c["route"] == "fused")
        verdict = {r: [c for c in cells if min(c["tuned_ms"][:r])
                       > GATE * min(c["default_ms"][:r])]
                   for r in sorted({3, args.rounds})}
        row = {"run": i, "seconds": time.perf_counter() - t0,
               "error": error, "cells": list(cells),
               "refused": {str(r): len(v) for r, v in verdict.items()}}
        runs.append(row)
        print(f"[gate] run={i} cells={len(cells)} "
              + " ".join(f"refused_at_{r}={len(v)} max_ratio_{r}="
                         f"{_max_ratio(cells, r):.3f}"
                         for r, v in verdict.items())
              + f" error={'yes' if error else 'no'}", flush=True)
        for c in verdict[3]:
            print(f"[gate] run={i} refused_at_3 {c['kernel']} "
                  f"{c['shape_key']} equal_plans={c['equal_plans']} "
                  f"tuned={min(c['tuned_ms'][:3]):.5f} "
                  f"default={min(c['default_ms'][:3]):.5f} ms", flush=True)
    out = {"gpu": chip_smoke.gpu_line(), "root": str(root),
           "rounds": args.rounds, "spin_cycles": spin,
           "stress": args.stress, "runs": runs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out))
    n = sum(len(r["cells"]) for r in runs)
    for r in sorted({3, args.rounds}):
        bad = sum(r_["refused"][str(r)] for r_ in runs)
        print(f"[gate] stress={args.stress} spin_cycles={spin} "
              f"rounds={r} cells_timed={n} refused={bad} "
              f"runs_refused={sum(1 for r_ in runs if r_['refused'][str(r)])}"
              f"/{len(runs)}")
    return 0


def _max_ratio(cells, r) -> float:
    return max((min(c["tuned_ms"][:r]) / min(c["default_ms"][:r])
                for c in cells), default=0.0)


if __name__ == "__main__":
    sys.exit(main())

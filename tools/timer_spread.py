"""The spread of chip_smoke.py's kernel, suite and compose rows with and
without the ~1 ms spin kernel ahead of each timed launch (GPU).

Runs `chip_smoke.kernel_phase`, `suite_phase` and `compose_phase` in
rounds, alternating the timer's spin (`chip_smoke.SPIN_CYCLES`) on and off
(on, off, off, on by default), and writes, for every row, its time in each
round and its spread in each mode: (max - min) / min over that mode's
rounds. Prints one summary line a mode (the median and the largest spread
over all rows, and over the rows under 0.1 ms) and the card's name and
power limit.

    python3 tools/timer_spread.py --out results/timer_spread.json
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def rows_of(kernel_records, suite_records, compose_log) -> dict:
    """{row label: kernel ms} of one round."""
    out = {}
    for rec in kernel_records + suite_records:
        for r in rec["rows"]:
            key = f"{rec['name']}:{r['shape']}:{r.get('dtype', '')}"
            out[key] = r["ms"]
    for line in compose_log.splitlines():
        if line.startswith("[compose]"):
            name = re.search(r"name=(\S+)", line).group(1)
            out[f"compose:{name}:fused"] = float(
                re.search(r"fused_ms=(\S+)", line).group(1))
            out[f"compose:{name}:composition"] = float(
                re.search(r"composition_ms=(\S+)", line).group(1))
    return out


def summary(rows: dict, rounds: list[int]) -> dict:
    spreads = {k: (max(v[i] for i in rounds) - min(v[i] for i in rounds))
               / min(v[i] for i in rounds) for k, v in rows.items()}
    small = [s for k, s in spreads.items()
             if min(rows[k][i] for i in rounds) < 0.1]

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else None

    return {"rows": len(spreads), "median": med(spreads.values()),
            "max": max(spreads.values()), "under_0.1ms_median": med(small),
            "under_0.1ms_max": max(small) if small else None,
            "spreads": spreads}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", default="on,off,off,on",
                    help="the spin of each round, in turn")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import chip_smoke
    from repro_torch.kernels import build, launches

    card = chip_smoke.gpu_line()
    print(card, flush=True)
    build.build()
    for name in build.SOURCES:
        build.library(name)
    spin = chip_smoke.SPIN_CYCLES
    order = args.order.split(",")
    rounds = []
    for mode in order:
        chip_smoke.SPIN_CYCLES = spin if mode == "on" else 0
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            kern = chip_smoke.kernel_phase()
            suite = chip_smoke.suite_phase(launches)
            chip_smoke.compose_phase(launches)
        rounds.append(rows_of(kern, suite, buf.getvalue()))
        print(f"round {len(rounds)} spin={mode} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    chip_smoke.SPIN_CYCLES = spin
    rows = {k: [r[k] for r in rounds] for k in rounds[0]}
    result = {"card": card, "order": order, "rows": rows}
    for mode in ("on", "off"):
        idx = [i for i, m in enumerate(order) if m == mode]
        if len(idx) >= 2:
            s = summary(rows, idx)
            result[mode] = s
            print(json.dumps({"spin": mode, **{k: v for k, v in s.items()
                                               if k != "spreads"}}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

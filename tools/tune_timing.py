"""How the tuning race's timer and chip_smoke.py's tune gate read plans of
one kernel that should time alike (GPU).

For a few tune cells (the Table 1 matmul, dotp and axpy, a decode
rmsnorm_matmul and conv2d) and each lane (the call with no knobs, the
kernel's own plan pinned, a rival plan pinned), it measures:

- host_us: the wrapper's host time a call (200 calls, no sync between);
- synced: the race's timer (`pipeline.median_time`'s loop: the L2 flushed,
  events around one launch, a sync after each rep);
- cushioned: the same behind a spin kernel of ~1 ms
  (`torch.cuda._sleep`), so the launch is queued before the GPU reaches
  the start event;
- graph: `chip_smoke.graph_ms` with the flush (device time only).

Each timer takes 21 samples a lane, the lanes in turn. Then it races the
matmul cell `--races` times under the synced and under the cushioned
timer (3 reps a lane, as chip_smoke's tune phase does) and counts the
picks. With `--stress N`, N processes spin on the host's cores the whole
time (a host whose cores are shared), and are stopped at the end.

    python3 tools/tune_timing.py --out chiprun_out/tune_timing.json

Prints one line a (cell, lane) and one a race, with the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPIN_CYCLES = 2_000_000        # ~1 ms at the H100's clocks


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=21)
    ap.add_argument("--races", type=int, default=8)
    ap.add_argument("--stress", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import multiprocessing as mp
    spinners = [mp.get_context("spawn").Process(target=_spin, daemon=True)
                for _ in range(args.stress)]
    for p in spinners:
        p.start()
    try:
        return _measure(args)
    finally:
        for p in spinners:
            p.terminate()
            p.join()


def _spin() -> None:
    while True:
        pass


def _measure(args) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops, table1
    from repro_torch.kernels import pipeline as pp

    gpu = cs.gpu_line()
    print(gpu, flush=True)
    build.build()
    dev = torch.device("cuda")
    flush = pp._l2_flush(dev)
    suite = table1.tune_operands(device="cuda")
    bf16 = torch.bfloat16
    cells = {
        "matmul": (suite["matmul"],
                   [{}, {"cluster": 3, "tile_n": 64},
                    {"cluster": 8, "tile_n": 128}]),
        "dotp": (suite["dotp"], [{}]),
        "axpy": (suite["axpy"], [{}]),
        "rmsnorm_matmul": (cs._tune_operands(
            "rmsnorm_matmul", {"m": 8, "k": 5120, "n": 5120}, bf16),
            [{}, {"boxes": 3, "cluster": 8}]),
        "conv2d": (suite["conv2d"], [{}]),
    }

    def synced(fn, cushion=False):
        if cushion:
            torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    rows = []
    for name, (operands, lanes) in cells.items():
        wrapper = ops.wrapper_for(name)
        fns = [lambda b=b: wrapper(*operands, **b) for b in lanes]
        host = []
        for fn in fns:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        samples = {k: [[] for _ in fns] for k in ("synced", "cushioned")}
        for _ in range(args.samples):
            for kind in samples:
                for i, fn in enumerate(fns):
                    samples[kind][i].append(synced(fn, kind == "cushioned"))
        graph = [cs.graph_ms(fn, iters=50, flush=flush) for fn in fns]
        for i, b in enumerate(lanes):
            row = {"kernel": name, "lane": b, "stress": args.stress,
                   "host_us": host[i],
                   "graph_ms": graph[i]}
            for kind, ts in samples.items():
                row[f"{kind}_ms"] = ts[i]
                row[f"{kind}_median_ms"] = statistics.median(ts[i])
                row[f"{kind}_min_ms"] = min(ts[i])
            rows.append(row)
            print(f"[timing] stress={args.stress} kernel={name} "
                  f"lane={json.dumps(b)} "
                  f"host_us={host[i]:.1f} graph_ms={graph[i]:.5f} "
                  + " ".join(f"{k}_median_ms={row[f'{k}_median_ms']:.5f} "
                             f"{k}_min_ms={row[f'{k}_min_ms']:.5f}"
                             for k in samples), flush=True)

    a, b = suite["matmul"]
    shapes = ops.kernel_shapes("matmul", a, b)
    races = []
    for kind in ("synced", "cushioned"):
        def timer(fn, blocks, _c=(kind == "cushioned")):
            fn()
            torch.cuda.synchronize()
            return statistics.median(synced(fn, _c) for _ in range(3)) * 1e-3
        for i in range(args.races):
            lanes = []

            def logged(fn, blocks, _t=timer):
                t = _t(fn, blocks)
                lanes.append((dict(blocks), t * 1e3))
                return t
            res = pp.autotune("matmul", shapes, dtype_bytes=4,
                              register_record=False, mode="timed",
                              timer=logged, top_n=3, device=dev)
            own = res.default_blocks
            races.append({"timer": kind, "run": i, "picked": res.blocks,
                          "own_plan": own, "route": res.route,
                          "lanes": lanes})
            print(f"[race] stress={args.stress} timer={kind} run={i} picked="
                  f"{json.dumps(res.blocks)} route={res.route} own="
                  f"{json.dumps(own)} lanes="
                  + ",".join(f"{json.dumps(l)}:{t:.5f}" for l, t in lanes),
                  flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"gpu": gpu, "rows": rows,
                                          "races": races}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the fixed batch's K-step decode chunk captured as CUDA graphs, on
one GPU: one graph of all K steps ("one_graph_of_k"), one step's graph
replayed K times back to back ("step_graph_k_times"), and the engine's
own path, `DecodeEngine.generate` of one chunk ("engine": its step graph
replayed K times through `Graphed`, then the host's read of the tokens).
The host syncs once a chunk in each.

    python3 tools/engine_chunk_graphs.py [--chunk 16] [--out FILE]

qwen3-14b at full width (40 layers, random weights from a seeded
generator, bf16), 8 slots, a private cache of 256 positions, the "fused"
policy, the chunk program of `runtime/engine.py`. For each variant, in
the order one, step, engine, engine, step, one: the host time the replay
calls take to return, the chunk's wall (replays then a synchronize; mean
of 5 after a warm-up), and from one profiler trace the device busy time
(the union of the kernels' spans), the idle time inside the chunk (the
gaps between kernels, and those over 0.1 ms, counted and summed), the
time from the first graph launch call to the first kernel, the first
launch call's own host time and the mean host time between two launch
calls. Prints one JSON line a variant and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch


def busy_ms(prof) -> tuple[float, float, int, float]:
    """The union of the kernels' spans (ms), and the gaps between them: all
    (ms), and those over 0.1 ms (count, ms)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if "CUDA" in str(getattr(e, "device_type", "")))
    busy, end, gaps, big = 0.0, None, 0.0, []
    for start, stop in spans:
        if end is None or start > end:
            if end is not None:
                gaps += start - end
                if start - end > 100:
                    big.append(start - end)
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e3, gaps / 1e3, len(big), sum(big) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("engine_chunk_graphs: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.models import steps
    from repro_torch.runtime.compile_cache import Captured
    from repro_torch.runtime.engine import DecodeEngine, decode_chunk_fn

    k = args.chunk
    cfg = get("qwen3-14b")
    params = steps.init_params(cfg, 0, device="cuda")
    cache = steps.init_cache(cfg, 8, 256, device="cuda")
    step = steps.make_decode_step(cfg, max_seq=256, policy="fused")
    with torch.inference_mode():
        s = {"tok": torch.ones(8, 1, dtype=torch.int64, device="cuda"),
             "finished": torch.zeros(8, dtype=torch.bool, device="cuda"),
             "emitted": torch.zeros(8, dtype=torch.int64, device="cuda"),
             "pos": torch.zeros((), dtype=torch.int64, device="cuda"),
             "remaining": torch.full((), 1 << 20, dtype=torch.int64,
                                     device="cuda")}

    def program(n):
        fn = decode_chunk_fn(step, n)
        return lambda: fn(params, cache, s["tok"], s["finished"],
                          s["emitted"], s["pos"], s["remaining"])

    with torch.inference_mode():
        graphs = {"one_graph_of_k": (Captured(program(k)), 1),
                  "step_graph_k_times": (Captured(program(1)), k)}
    engine = DecodeEngine(step, k)
    start = torch.ones(8, 1, dtype=torch.int64).numpy()
    engine.generate(params, cache, start, k, start_pos=32)   # captures

    def run(name):
        if name == "engine":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(params, cache, start, k, start_pos=32)
            wall = (time.perf_counter() - t0) * 1e3
            return wall, wall
        graph, times = graphs[name]
        with torch.inference_mode():
            s["pos"].fill_(32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(times):
            graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = []
    for name in ("one_graph_of_k", "step_graph_k_times", "engine", "engine",
                 "step_graph_k_times", "one_graph_of_k"):
        run(name)
        timed = [run(name) for _ in range(5)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.1)
            run(name)
            time.sleep(0.1)
        launch = sorted((e for e in prof.events()
                         if e.name.startswith("cudaGraphLaunch")),
                        key=lambda e: e.time_range.start)
        kernels = sorted(e.time_range.start for e in prof.events()
                         if "CUDA" in str(getattr(e, "device_type", ""))
                         and launch
                         and e.time_range.start >= launch[0].time_range.start)
        busy, gaps, n_big, big = busy_ms(prof)
        row = {"variant": name, "chunk": k,
               "host_replay_ms": sum(t[0] for t in timed) / 5,
               "wall_ms": sum(t[1] for t in timed) / 5,
               "wall_ms_per_step": sum(t[1] for t in timed) / 5 / k,
               "traced_busy_ms": busy, "traced_gaps_ms": gaps,
               "traced_gaps_over_0.1ms": n_big,
               "traced_gaps_over_0.1ms_ms": big,
               "launch_interval_ms": (launch[-1].time_range.start
                                      - launch[0].time_range.start)
               / 1e3 / (len(launch) - 1) if len(launch) > 1 else None,
               "first_launch_call_ms": (launch[0].time_range.end
                                        - launch[0].time_range.start) / 1e3
               if launch else None,
               "launch_to_first_kernel_ms": (kernels[0]
                                             - launch[0].time_range.start)
               / 1e3 if launch and kernels else None,
               "gpu": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a serving step on a one-rank (data=1, model=1) mesh spends the
time that the plain step does not (GPU): qwen3-14b at full width (depth
`--layers`, default all 40) under "fused", the sharded prefill (B 1, S
512) and decode step (8 slots, per-slot positions) against the plain
eager steps, in one process over a one-rank NCCL group.

First the host's time a call of the backend's one-rank all_reduce;
then the plain and the mesh step timed in turn, and where the host's
time goes (a stack sampler). Then for each of the four steps, after two
warm-up calls: the host wall of `--calls` synced calls (median), the
device's busy time and the kernels, the host's time in the c10d / NCCL
calls, the aten ops issued and the allocator's retries
(`torch.profiler` over one call), and the Python functions that take
the host's time (`cProfile` over one call); these follow the process's
first profiler session, so they are compared with each other and not
with the turn-by-turn times. One line a step on stdout, with the card's
name and power limit; the profiler's and cProfile's tables under
`--out`.

    python3 tools/mesh_trace.py                 # ~2 min with the build
    python3 tools/mesh_trace.py --layers 8 --out results/mesh_trace_8
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import io
import json
import pstats
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=0,
                    help="qwen3-14b's layers (0: all 40)")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "results" / "mesh_trace"),
                    help="folder for the profiler's and cProfile's tables")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a gloo group (checks the script itself)")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs import get
    from repro_torch.core.addressing import MeshSpec
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import steps

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = args.device
    if dev == "cuda":
        print(chip_smoke.gpu_line(), flush=True)
        build.build(chip_smoke.QWEN_FUSED)
    cfg = get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = steps.init_params(cfg, 0, device=dev)
    B, S = 8, 1024
    rng = np.random.default_rng(30)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 512))).to(dev)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32)).to(dev)
    starts = torch.from_numpy((np.arange(B) * 960) // B).to(dev)
    clen = steps.decode_cache_len(cfg, S)

    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group(
            "nccl" if dev == "cuda" else "gloo",
            store=dist.FileStore(f"{root}/store", 1), rank=0, world_size=1)
        try:
            mesh = make_device_mesh(MeshSpec((1, 1), ("data", "model")),
                                    dev)
            runs = {
                "plain_prefill": (steps.make_prefill_step(
                    cfg, policy="fused").eager, None),
                "mesh_prefill": (steps.make_sharded_prefill_step(
                    cfg, mesh, policy="fused", max_seq=512, batch=1), None),
                "plain_decode": (steps.make_decode_step(
                    cfg, S, policy="fused"), clen),
                "mesh_decode": (steps.make_sharded_decode_step(
                    cfg, mesh, S, policy="fused", batch=B), clen),
            }
            backend_cost(mesh.get_group("model"), dev)
            calls = {}
            for name, (fn, cache_len) in runs.items():
                if cache_len is None:
                    calls[name] = lambda fn=fn: fn(params, {"tokens": prompt})
                else:
                    cache = steps.init_cache(cfg, B, cache_len, device=dev)
                    calls[name] = lambda fn=fn, cache=cache: fn(
                        params, cache, {"tokens": tok, "pos": starts})
            for kind in ("prefill", "decode"):
                alternate(kind, calls[f"plain_{kind}"],
                          calls[f"mesh_{kind}"], args.calls, dev)
            for name, call in calls.items():
                trace(name, call, args.calls, out_dir, profile,
                      ProfilerActivity, dev)
        finally:
            dist.destroy_process_group()
    return 0


def backend_cost(group, dev, n: int = 200) -> None:
    """The host's time a call of the backend's own all_reduce on the
    one-rank group, what a collective there cost before it skipped the
    backend: `n` calls on a decode step's (8, 1, 5120) and a prefill's
    (1, 512, 5120) bf16 partial, issue time (until the call returns) and
    wall (to the device's end), before any profiler session."""
    import torch
    import torch.distributed as dist

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    for shape in ((8, 1, 5120), (1, 512, 5120)):
        t = torch.ones(shape, dtype=torch.bfloat16, device=dev)
        for _ in range(10):
            dist.all_reduce(t, group=group)
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(t, group=group)
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        print(f"[trace] backend=all_reduce ranks=1 shape="
              f"{'x'.join(map(str, shape))} calls={n} "
              f"issue_us={(t1 - t0) / n * 1e6:.1f} "
              f"wall_us={(t2 - t0) / n * 1e6:.1f}", flush=True)


def alternate(kind, plain, mesh, rounds, dev) -> None:
    """The plain and the mesh step timed in turn (plain, mesh, mesh,
    plain, `rounds` times), with the garbage collector on and then off:
    the host's time to issue a call (until it returns) and the wall (to
    the device's end), medians; then where the host's time goes, from
    a sampler thread reading the main thread's stack every 0.5 ms over
    ten calls of each (the innermost frame of the port, by line)."""
    import gc

    import torch

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    for f in (plain, mesh, plain, mesh):
        f()
    sync()
    for collect in (True, False):
        got = {"plain": ([], []), "mesh": ([], [])}
        gc.collect()
        if not collect:
            gc.disable()
        try:
            for _ in range(rounds):
                for tag in ("plain", "mesh", "mesh", "plain"):
                    f = plain if tag == "plain" else mesh
                    t0 = time.perf_counter()
                    f()
                    t1 = time.perf_counter()
                    sync()
                    t2 = time.perf_counter()
                    got[tag][0].append((t1 - t0) * 1e3)
                    got[tag][1].append((t2 - t0) * 1e3)
        finally:
            gc.enable()
        print(f"[trace] alternate={kind} gc={'on' if collect else 'off'} "
              + " ".join(f"{tag}_issue_ms={statistics.median(v[0]):.2f} "
                         f"{tag}_wall_ms={statistics.median(v[1]):.2f}"
                         for tag, v in got.items()), flush=True)
    for tag, f in (("plain", plain), ("mesh", mesh)):
        print(f"[trace] sampled={kind} path={tag} top=" + json.dumps(
            _sampled(f, sync)), flush=True)


def _sampled(call, sync, n: int = 10, top: int = 14) -> list:
    import collections
    import threading

    main = threading.get_ident()
    seen: collections.Counter = collections.Counter()
    stop = threading.Event()

    def sample():
        while not stop.wait(0.0005):
            frame = sys._current_frames().get(main)
            where = None
            while frame is not None:
                code = frame.f_code
                if "repro_torch" in code.co_filename and where is None:
                    where = (f"{Path(code.co_filename).name}:"
                             f"{frame.f_lineno}:{code.co_name}")
                frame = frame.f_back
            seen[where or "other"] += 1

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        for _ in range(n):
            call()
        sync()
    finally:
        stop.set()
        thread.join()
    total = sum(seen.values()) or 1
    return [(k, round(v / total, 3)) for k, v in seen.most_common(top)]


def trace(name, call, calls, out_dir, profile, activity, dev) -> None:
    import torch

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    mem = torch.cuda.memory_stats if dev == "cuda" else dict

    for _ in range(2):
        call()
    sync()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        call()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)

    prof = cProfile.Profile()
    prof.enable()
    call()
    sync()
    prof.disable()
    buf = io.StringIO()
    st = pstats.Stats(prof, stream=buf)
    st.sort_stats("tottime").print_stats(40)
    st.sort_stats("cumulative").print_stats(60)
    (out_dir / f"{name}.cprofile.txt").write_text(buf.getvalue())

    before = mem()
    acts = [activity.CPU] + ([activity.CUDA] if dev == "cuda" else [])
    with profile(activities=acts) as p:
        call()
        sync()
    after = mem()
    ka = p.key_averages()
    (out_dir / f"{name}.ops.txt").write_text(
        ka.table(sort_by="self_cpu_time_total", row_limit=60) + "\n" +
        ka.table(sort_by="self_device_time_total", row_limit=40))
    events = [e for e in p.events() if e.device_type.name == "CUDA"]
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in events])
    ops = [e for e in ka if e.key.startswith("aten::")]
    c10d = [e for e in ka if "c10d" in e.key or "nccl" in e.key.lower()]
    top = sorted(((e.self_cpu_time_total, e.key) for e in ka),
                 reverse=True)[:8]
    c10d = [e for e in c10d if "c10d" in e.key]
    grew = lambda k: after.get(k, 0) - before.get(k, 0)
    print(f"[trace] step={name} host_ms={statistics.median(walls):.2f} "
          f"host_ms_all={json.dumps([round(w, 2) for w in walls])} "
          f"device_busy_ms={busy:.2f} kernels={len(events)} "
          f"aten_calls={sum(e.count for e in ops)} "
          f"c10d_calls={sum(e.count for e in c10d)} "
          f"c10d_cpu_ms={sum(e.cpu_time_total for e in c10d) / 1e3:.2f} "
          f"alloc_retries={grew('num_alloc_retries')} "
          f"cuda_mallocs={grew('num_device_alloc')} "
          "top_self_cpu=" + json.dumps([(k, round(t / 1e3, 2))
                                        for t, k in top]), flush=True)
    print(f"[trace] step={name} cprofile_top=" + json.dumps(
        _cprofile_top(prof)), flush=True)


def _cprofile_top(prof, n: int = 12) -> list:
    st = pstats.Stats(prof)
    rows = []
    for (file, line, fn), (_, nc, tt, ct, _) in st.stats.items():
        rows.append((tt, ct, nc, f"{Path(file).name}:{line}:{fn}"))
    rows.sort(reverse=True)
    return [(r[3], r[2], round(r[0] * 1e3, 2), round(r[1] * 1e3, 2))
            for r in rows[:n]]


def _union_ms(spans) -> float:
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


if __name__ == "__main__":
    sys.exit(main())

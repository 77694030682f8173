"""Sharded serving on the PyTorch port: a cluster of session cells behind
one submit/poll (the flow of `examples/serve_sharded.py`).

MemPool scales past one cluster by tiling the hierarchy — PEs into
tiles, tiles into groups — and routing traffic so most accesses stay
local. This example runs the serving-side analogue: `--groups` full
session cells (each with its own slot pool, paged KV pool and prefix
cache) behind a single `ShardedServeSession`, with the two-level
scheduler placing every arrival by modeled latency: measured
prefix-cache overlap is the local-access probability, occupancy the
injected load.

About 60% of the prompts open with a shared hot preamble (a system
prompt, in serving terms). Once one request carrying it finishes in
some group, that group's prefix cache holds the preamble pages — and
the mesh scheduler starts steering preamble-carrying arrivals there,
where prefill can be skipped copy-on-write. The placement ledger at the
end shows the effect: `locality rate` is the fraction of placements
that went to a group with measured page overlap.

    PYTHONPATH=src python examples/serve_sharded_torch.py --groups 4

The groups run on the GPU (round-robin over the cards this process
sees; on one card they share it and its parameter tree); `--device cpu`
runs them on the CPU. `--arch` names the model (default the qwen3-14b
smoke config; `--arch qwen3-14b` serves it at full width).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.cluster import (Cluster,  # noqa: E402
                                 ShardedServeSessionProgram)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b-smoke")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2,
                    help="slot-pool size per group")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=12.0,
                    help="mean request arrivals per second (Poisson)")
    ap.add_argument("--hot", type=float, default=0.6,
                    help="fraction of prompts opening with the shared "
                         "preamble")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cluster = Cluster(args.arch, device=args.device)
    cfg = cluster.arch
    program = cluster.compile(ShardedServeSessionProgram(
        groups=args.groups, slots=args.slots, max_seq=32, max_prompt=8,
        chunk=4, paged=True, page_size=4))
    session = program.open()

    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    preamble = rng.integers(0, cfg.vocab, size=5).astype(np.int32)
    prompts, hot_flags = [], []
    for _ in range(args.requests):
        hot = rng.random() < args.hot
        tail_len = int(rng.integers(1, 4))
        tail = rng.integers(0, cfg.vocab, size=tail_len).astype(np.int32)
        prompts.append(np.concatenate([preamble, tail]) if hot else tail)
        hot_flags.append(hot)
    out_lens = rng.choice([4, 8, 12, 16], size=args.requests)

    print(f"arch={cfg.name} device={cluster.device} groups={args.groups} "
          f"slots={args.slots}/group paged page_size=4 — {args.requests} "
          f"requests, ~{args.rate}/s Poisson, {sum(hot_flags)} share the "
          f"hot preamble ({len(preamble)} tokens); degraded="
          f"{session.plan.degraded}")

    # Warm-up: run the preamble through once so some group's prefix
    # cache holds its pages before the Poisson wave arrives (otherwise
    # every arrival lands cold while the first batch is still decoding).
    warm = session.submit(preamble, 2)
    session.drain()
    print(f"warm-up: preamble published in group {warm.group}'s "
          f"prefix cache")

    t0 = time.perf_counter()
    next_up = 0
    delivered = 0
    while next_up < args.requests or session.busy:
        now = time.perf_counter() - t0
        while next_up < args.requests and arrivals[next_up] <= now:
            h = session.submit(prompts[next_up], int(out_lens[next_up]))
            tag = "hot " if hot_flags[next_up] else "cold"
            print(f"  req {h.id} ({tag}, {prompts[next_up].size} tok) "
                  f"-> group {h.group}")
            next_up += 1
        events = session.poll()
        for handle, toks, done in events:
            delivered += len(toks)
            if done:
                print(f"  req {handle.id} [g{handle.group}] done: "
                      f"{handle.tokens.size} tokens, "
                      f"latency {handle.latency_s * 1e3:.0f}ms")
        if not events and next_up < args.requests:
            time.sleep(min(0.005, max(arrivals[next_up] - now, 0.0)))
    wall = time.perf_counter() - t0

    st = session.stats()
    pl = st["placement"]
    print(f"\ndone: {st['requests_done']} requests, "
          f"{st['emitted_total']} tokens; {delivered} delivered over the "
          f"drive's {wall:.2f}s wall = {delivered / wall:.1f} tok/s "
          f"(the groups' summed windowed rates: "
          f"{st['tokens_per_s']:.1f} tok/s, not a throughput when groups "
          f"share a device) across {st['n_groups']} groups")
    print(f"placement: {pl['placed']} per group — "
          f"{pl['locality_hits']}/{pl['placements']} placements had warm "
          f"prefix pages (locality rate {pl['locality_rate']:.0%})")
    for gid in sorted(st["groups"]):
        g = st["groups"][gid]
        kv = g.get("kv", {})
        print(f"  group {gid}: {g['requests_done']} done, "
              f"occupancy {g['occupancy_pct']:.0f}%, "
              f"prefix hits {kv.get('prefix_hits', 0)}, "
              f"prefill skipped {kv.get('prefill_skipped_tokens', 0)} tok, "
              f"stall {g['stall']['stall_pct']:.1f}%")
    kv = st.get("kv", {})
    stall = st["stall"]
    print(f"fleet: kv occupancy {kv.get('occupancy_pct', 0.0):.0f}%, "
          f"{kv.get('prefill_skipped_tokens', 0)} prompt tokens never "
          f"prefilled, stall {stall['stall_pct']:.1f}% "
          f"(load-average over {st['n_groups']} groups)")
    session.close()
    return dict(st, delivered=delivered, wall_s=wall)


if __name__ == "__main__":
    main()

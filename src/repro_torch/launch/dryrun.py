"""Multi-pod dry run of the port: trace every (arch x shape) on the
production meshes and write one JSON record a cell (the port of
`repro.launch.dryrun`).

A thin wrapper over the Cluster façade: each cell builds a
`repro_torch.cluster.Cluster` on the production mesh (a `MeshSpec`, on
the meta device: no card is needed) and compiles a `DryRunProgram` on it
(`cluster/session.py` `CompiledDryRun`: this rank's cell traced on meta
tensors over a fake process group of 256 or 512 ranks, along the card's
kernel route); this module keeps the CLI, the variant table and the JSON
envelope. The fake world's size is set when the cell starts, so nothing
happens at import.

A split the step does not compute is recorded ``"refused"`` and the cell
exits 1, as the reference's does for a cell that fails to lower. The
records go to ``results/dryrun_torch/``; `launch/roofline.py` renders
them.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch xlstm-125m --variant tponly --mesh both
                                                   # every shape, in this process
  python -m repro_torch.launch.dryrun --all --mesh both --jobs 4   # a process a cell
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

from repro_torch.cluster import Cluster, DryRunProgram
from repro_torch.configs import ARCHS, SHAPES, get
from repro_torch.launch.mesh import make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


# The reference's hillclimb variants (`repro/launch/dryrun.py:43-60`):
# config deltas on top of the baseline; "_fsdp_gather" is a build switch
# (`build_cell(fsdp_gather=True)`: the per-layer gather), not a field.
VARIANTS: dict[str, dict] = {
    "folded": {"attn_schedule": "folded"},          # exact-causal schedule
    "localmoe": {"moe_local_dispatch": True},       # shard-local dispatch
    "tponly": {"rules_overrides": (("embed", None),)},  # no FSDP: p_local max
    "localmoe_tponly": {"moe_local_dispatch": True,
                        "rules_overrides": (("embed", None),)},
    "chunk512": {"attn_chunk": 512},
    "chunk2048": {"attn_chunk": 2048},
    "accum4": {"grad_accum": 4},
    "folded_chunk2048": {"attn_schedule": "folded", "attn_chunk": 2048},
    "fsdpgather": {"_fsdp_gather": True},
    "fsdpgather_localmoe": {"_fsdp_gather": True, "moe_local_dispatch": True},
    "fsdpgather_folded": {"_fsdp_gather": True, "attn_schedule": "folded"},
    "cap1": {"capacity_factor": 1.0},
    "cap1_localmoe": {"capacity_factor": 1.0, "moe_local_dispatch": True},
}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Path = RESULTS, variant: str | None = None) -> dict:
    cfg = get(arch)
    fsdp_gather = False
    if variant:
        deltas = dict(VARIANTS[variant])
        fsdp_gather = deltas.pop("_fsdp_gather", False)
        if deltas:
            cfg = dataclasses.replace(cfg, **deltas)
    multi = mesh_kind == "multi"
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "variant": variant, "timestamp": time.time()}

    cluster = Cluster(cfg, make_production_mesh(multi_pod=multi),
                      device="meta")
    program = cluster.compile(DryRunProgram(shape=shape_name,
                                            fsdp_gather=fsdp_gather))
    record |= program.run()
    _write(record, out_dir)
    return record


def _write(record: dict, out_dir: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}"
    if record.get("variant"):
        name += f"__{record['variant']}"
    (out_dir / (name + ".json")).write_text(
        json.dumps(record, indent=2, default=float))
    print(f"[dryrun] wrote {name}.json: status={record.get('status')}",
          flush=True)


def run_all(mesh_kinds: list[str], timeout: int = 3600,
            jobs: int = 1, only_missing: bool = False,
            out_dir: Path = RESULTS) -> list:
    """Every (arch x shape x mesh) cell of the registry, each in a
    process of its own, `jobs` at a time -> the failed cells
    (a refused cell, a crash or a timeout)."""
    cells = [(a, s, m) for a in ARCHS for s in SHAPES for m in mesh_kinds]
    if only_missing:
        cells = [c for c in cells
                 if not (out_dir / f"{c[0]}__{c[1]}__{c[2]}.json").exists()]
    print(f"[dryrun] {len(cells)} cells to run", flush=True)
    procs: list[tuple] = []
    results = []

    def drain(block_all=False):
        """Reap finished (or timed-out) cells until a slot is free, or
        every cell when `block_all`."""
        while procs and (block_all or len(procs) >= jobs):
            for entry in list(procs):
                p, cell, t0 = entry
                rc = p.poll()
                if rc is None and time.time() - t0 > timeout:
                    p.kill()
                    p.wait()
                    rc = -9
                if rc is None:
                    continue
                procs.remove(entry)
                results.append((cell, rc, time.time() - t0))
                print(f"[dryrun] {cell} rc={rc} ({time.time() - t0:.1f}s)",
                      flush=True)
            time.sleep(0.2)

    for cell in cells:
        drain()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               cell[0], "--shape", cell[1], "--mesh", cell[2],
               "--out", str(out_dir)]
        procs.append((subprocess.Popen(cmd), cell, time.time()))
    drain(block_all=True)
    failed = [c for c, rc, _ in results if rc != 0]
    print(f"[dryrun] done; {len(failed)} failed: {failed}", flush=True)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS))
    ap.add_argument("--out", default=str(RESULTS),
                    help="the records' directory")
    args = ap.parse_args(argv)
    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out = Path(args.out)
    if args.all:
        failed = run_all(kinds, timeout=args.timeout, jobs=args.jobs,
                         only_missing=args.only_missing, out_dir=out)
        sys.exit(1 if failed else 0)
    if not args.arch:
        ap.error("--arch is required without --all")
    refused = False
    try:
        for kind in kinds:
            for shape in [args.shape] if args.shape else list(SHAPES):
                rec = run_cell(args.arch, shape, kind, out_dir=out,
                               variant=args.variant)
                if rec["status"] == "refused":
                    print(f"[dryrun] refused: {rec['reason']}",
                          file=sys.stderr)
                    refused = True
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    if refused:
        sys.exit(1)


if __name__ == "__main__":
    main()

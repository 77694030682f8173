"""Roofline terms of one kernel invocation on the H100, and the dry
run's tables — the port of `repro.launch.roofline`.

`kernel_roofline` / `fused_roofline` score one kernel call; `load`,
`baseline_table`, `variant_table`, `multi_pod_table` and `sweep_table`
(the first and the last in one) render the port's dry-run records (`launch/dryrun.py`, ``results/dryrun_torch/``)
as the reference's tables, with the card's peak memory flagged where a
cell's predicted peak passes it. These are the host's arithmetic over a
meta trace, not times measured on the card.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh multi]
       [--variants | --sweep]

The constants come from `core/mesh.py`. A kernel's operations run at the
peak of their operand type: bf16 on the tensor cores, TF32 for the f32
matmul's 3xTF32 route (count its three products in `flops`), or f32 on
the CUDA cores.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.core import mesh as hw


def kernel_roofline(flops: float, hbm_bytes: float,
                    peak_flops: float = hw.PEAK_FLOPS_BF16) -> dict:
    """Roofline terms (seconds) of one kernel invocation on one card."""
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / hw.HBM_BW
    intensity = flops / max(hbm_bytes, 1.0)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "dominant": "compute_s" if compute_s >= memory_s else "memory_s",
        "intensity": intensity,
        "roof_flops": min(peak_flops, intensity * hw.HBM_BW),
    }


def fused_roofline(flops: float, hbm_bytes: float, saved_bytes: float,
                   peak_flops: float = hw.PEAK_FLOPS_BF16) -> dict:
    """Roofline of a fused kernel with the dropped intermediate made
    explicit: the unfused composition would stream `hbm_bytes +
    saved_bytes` (the intermediate's write and read)."""
    r = kernel_roofline(flops, hbm_bytes, peak_flops)
    unfused = kernel_roofline(flops, hbm_bytes + saved_bytes, peak_flops)
    r.update({
        "saved_bytes": saved_bytes,
        "saved_s": saved_bytes / hw.HBM_BW,
        "unfused_memory_s": unfused["memory_s"],
        "traffic_reduction": (hbm_bytes + saved_bytes) / max(hbm_bytes, 1.0),
    })
    return r


# ----------------------------------------------------------------------------
# the dry run's tables (`launch/dryrun.py`'s records)
# ----------------------------------------------------------------------------

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def load(mesh: str = "single", variants: bool = False,
         results: Path = RESULTS) -> list[dict]:
    rows = []
    for p in sorted(Path(results).glob("*.json")):
        d = json.loads(p.read_text())
        if d.get("mesh") != mesh:
            continue
        if bool(d.get("variant")) != variants:
            continue
        rows.append(d)
    return rows


def _fmt(x: float, digits: int = 2) -> str:
    if x == 0:
        return "0"
    if x >= 100:
        return f"{x:.0f}"
    return f"{x:.{digits}f}"


def _note(d: dict) -> str:
    """A cell whose predicted peak passes the card's memory."""
    if d["peak_device_bytes"] > hw.HBM_BYTES:
        return f"peak > {hw.HBM_BYTES / 1e9:.0f} GB"
    return ""


def baseline_table(mesh: str = "single", results: Path = RESULTS) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| GFLOPs/chip | GB/chip traffic | peak GB/chip | "
           "MODEL/traced flops | note |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for d in load(mesh, results=results):
        if d["status"] != "ok":
            lines.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | — "
                         f"| — | — | — | {d['status']}: "
                         f"{d['reason'][:60]} |")
            continue
        r = d["roofline"]
        h = d["hlo"]
        lines.append(
            f"| {d['arch']} | {d['shape']} | {_fmt(r['compute_s'])} "
            f"| {_fmt(r['memory_s'])} | {_fmt(r['collective_s'])} "
            f"| **{r['dominant'].replace('_s', '')}** "
            f"| {h['flops_per_device'] / 1e9:.0f} "
            f"| {h['bytes_per_device'] / 1e9:.0f} "
            f"| {d['peak_device_bytes'] / 2**30:.1f} "
            f"| {r['useful_flops_ratio']:.3f} | {_note(d)} |")
    return "\n".join(lines)


def variant_table(results: Path = RESULTS) -> str:
    hdr = ("| arch | shape | variant | compute s | memory s | collective s "
           "| MODEL/traced flops | peak GB |")
    sep = "|" + "---|" * 8
    lines = [hdr, sep]
    for d in load("single", variants=True, results=results):
        if d["status"] != "ok":
            continue
        r = d["roofline"]
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['variant']} "
            f"| {_fmt(r['compute_s'])} | {_fmt(r['memory_s'])} "
            f"| {_fmt(r['collective_s'])} | {r['useful_flops_ratio']:.3f} "
            f"| {d['peak_device_bytes'] / 2**30:.1f} |")
    return "\n".join(lines)


def multi_pod_table(results: Path = RESULTS) -> str:
    single = {(d["arch"], d["shape"]): d
              for d in load("single", results=results)}
    hdr = ("| arch | shape | 256-chip dominant s | 512-chip dominant s "
           "| scaling | collectives 512 (GB/chip) |")
    sep = "|" + "---|" * 6
    lines = [hdr, sep]
    for d in load("multi", results=results):
        if d["status"] != "ok":
            continue
        s = single.get((d["arch"], d["shape"]))
        if not s or s["status"] != "ok":
            continue
        rm, rs = d["roofline"], s["roofline"]
        dm = max(rm["compute_s"], rm["memory_s"], rm["collective_s"])
        ds = max(rs["compute_s"], rs["memory_s"], rs["collective_s"])
        lines.append(
            f"| {d['arch']} | {d['shape']} | {_fmt(ds)} | {_fmt(dm)} "
            f"| {ds / max(dm, 1e-12):.2f}x "
            f"| {d['hlo']['collective_operand_bytes_per_device'] / 1e9:.1f} |")
    return "\n".join(lines)


def sweep_table(results: Path = RESULTS) -> str:
    """The baseline and multi-pod tables in one: a row a base (arch,
    shape) cell, each mesh's dominant term and peak, the scaling, the
    512-rank collectives, the 256-rank MODEL / traced flops and each
    mesh's trace seconds."""
    cells = {}
    for mesh in ("single", "multi"):
        for d in load(mesh, results=results):
            cells.setdefault((d["arch"], d["shape"]), {})[mesh] = d
    hdr = ("| arch | shape | 256: dominant s | 256 peak GB | 512: dominant "
           "s | 512 peak GB | scaling | collectives 512 (GB/chip) | "
           "MODEL/traced flops | trace s 256 / 512 | note |")
    lines = [hdr, "|" + "---|" * 11]
    for (arch, shape), by in cells.items():
        s, m = by.get("single"), by.get("multi")
        if not (s and m and s["status"] == m["status"] == "ok"):
            bad = [d for d in (s, m) if d and d["status"] != "ok"]
            if any(d["status"] == "skipped" for d in bad):
                continue
            why = (f"{bad[0]['status']}: {bad[0]['reason'][:60]}" if bad
                   else "a mesh's record is missing")
            lines.append(f"| {arch} | {shape} | {why} ||||||||| |")
            continue
        rs, rm = s["roofline"], m["roofline"]
        ds = max(rs["compute_s"], rs["memory_s"], rs["collective_s"])
        dm = max(rm["compute_s"], rm["memory_s"], rm["collective_s"])
        note = ", ".join(n for n in (_note(s) and "256 " + _note(s),
                                     _note(m) and "512 " + _note(m)) if n)
        lines.append(
            f"| {arch} | {shape} | {rs['dominant'].replace('_s', '')} "
            f"{_fmt(ds)} | {s['peak_device_bytes'] / 1e9:.1f} "
            f"| {rm['dominant'].replace('_s', '')} {_fmt(dm)} "
            f"| {m['peak_device_bytes'] / 1e9:.1f} "
            f"| {ds / max(dm, 1e-12):.2f}x "
            f"| {m['hlo']['collective_operand_bytes_per_device'] / 1e9:.1f} "
            f"| {rs['useful_flops_ratio']:.3f} "
            f"| {s['seconds']['trace']:.0f} / {m['seconds']['trace']:.0f} "
            f"| {note} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="both meshes in one table")
    args = ap.parse_args(argv)
    if args.sweep:
        print(sweep_table())
    elif args.variants:
        print(variant_table())
    else:
        print(baseline_table(args.mesh))
        print()
        print(multi_pod_table())


if __name__ == "__main__":
    main()

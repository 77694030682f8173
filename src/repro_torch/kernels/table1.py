"""The Table 1 suite through the tuning layer: the `table1_tuned/*` rows.

The port's counterpart of `benchmarks/bench_table1_kernels.py`'s
`_tune_operands` / `tuned_rows` (same sizes, same row fields) and of the
line its `main` writes for each row (`gate_rows`: the record rows
`benchmarks/check_gate.py` holds to tuned <= default x (1 + tol)).

    rows = tuned_rows()                   # on the card; device="cpu" too
    record = {"rows": gate_rows(rows)}
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from . import ops
from . import pipeline as pp


def tune_operands(smoke: bool = False, device=None) -> dict[str, tuple]:
    """f32 operands for each Table 1 kernel and rmsnorm / flash attention,
    at the reference bench's sizes (its `_tune_operands`), from one seeded
    generator on `device` (the card unless given)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    if smoke:
        mn, mm, s = (64, 128), (128, 128, 128), 128
        hwc, nblk, rms = (32, 256), 256, (64, 128)
    else:
        mn, mm, s = (768, 128), (512, 512, 512), 512
        hwc, nblk, rms = (96, 1024), 3072, (512, 512)
    return {
        "axpy": (2.0, rand(*mn), rand(*mn)),
        "dotp": (rand(*mn), rand(*mn)),
        "matmul": (rand(mm[0], mm[2]), rand(mm[2], mm[1])),
        "conv2d": (rand(*hwc), rand(3, 3)),
        "dct8x8": (rand(nblk, 8, 8),),
        "rmsnorm": (rand(*rms), rand(rms[-1]) * 0.1),
        "flash_attention": (rand(1, 4, s, 64), rand(1, 2, s, 64),
                            rand(1, 2, s, 64)),
    }


def tuned_rows(smoke: bool = False, device=None, reps: int | None = None,
               operands: dict | None = None) -> list[dict]:
    """One row a kernel: its tune record (registry first, so a warm TuneDB
    races nothing; a miss races on `device`) and the tuned and default
    times. A timed record's times are the race's own; an untimed one's
    are timed here through the wrappers (medians, CUDA events on the
    card)."""
    dev = resolve_device(device)
    reps = (1 if smoke else 3) if reps is None else reps
    out = []
    for name, args in (operands or tune_operands(smoke, dev)).items():
        shapes = ops.kernel_shapes(name, *args)
        db = args[ops.OPS[name].streamed_operand].dtype.itemsize
        rec = pp.tuned_record(name, shapes, dtype_bytes=db, device=dev)
        if rec.timed:
            us_tuned, us_default = rec.measured_us, rec.default_us
        else:
            wrapper = ops.wrapper_for(name)
            us_default = pp.median_time(
                lambda: wrapper(*args, **dict(rec.default_blocks)),
                reps=reps, device=dev) * 1e6
            us_tuned = pp.median_time(
                lambda: ops.tuned_call(name, *args), reps=reps,
                device=dev) * 1e6
        cost = pp.score(pp.KERNELS[name].traffic(shapes, dict(rec.blocks),
                                                 db))
        out.append({
            "name": f"table1_tuned/{name}",
            "blocks": dict(rec.blocks),
            "default_blocks": dict(rec.default_blocks),
            "us_default": us_default,
            "us_tuned": us_tuned,
            "modeled_default_s": rec.default_modeled_seconds,
            "modeled_tuned_s": rec.modeled_seconds,
            "measured_speedup": rec.measured_speedup,
            "source": rec.source,
            "route": rec.route,
            "p_local": cost.p_local,
        })
    return out


def gate_rows(rows: list[dict]) -> list[dict]:
    """The record rows `benchmarks/check_gate.py` reads, as the reference
    bench writes them: us_per_call is the tuned time, `derived` carries
    default_us, the knobs, the speedup, the source and p_local."""
    out = []
    for r in rows:
        knobs = "/".join(f"{k}={v}" for k, v in sorted(r["blocks"].items()))
        out.append({
            "name": r["name"], "us_per_call": r["us_tuned"],
            "derived": (f"default_us={r['us_default']:.1f};blocks={knobs};"
                        f"measured_speedup={r['measured_speedup']:.2f};"
                        f"source={r['source']};p_local={r['p_local']:.3f}")})
    return out

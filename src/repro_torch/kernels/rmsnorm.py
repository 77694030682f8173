"""rmsnorm — row RMSNorm with ``(1 + scale)``: wrapper, plain version,
launch count. Replaces `repro/kernels/rmsnorm.py` _rmsnorm_kernel /
rmsnorm; the kernel is `csrc/rmsnorm.cu` (bound and design in its notes).

The wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernel, or raises (see `fused.py` for the counting convention).
"""

from __future__ import annotations

import torch

from repro_torch.core import mesh as hw
from repro_torch.device import on_card

from . import build, pipeline, ref, traced

DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_plain(x, scale, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * (1 + scale) in f32, rounded once to
    x.dtype."""
    traced.count_plain(rmsnorm_plain, x)
    return ref.rmsnorm(x, scale, eps)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (M, D); scale: (D,) -> (M, D) in x.dtype (f32 or bf16 on CUDA)."""
    m, d = x.shape
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: shapes {tuple(x.shape)}, "
                         f"{tuple(scale.shape)}")
    if not on_card(x):
        return rmsnorm_plain(x, scale, eps)
    build.check_operands("rmsnorm", x, scale, dtypes=DTYPES)
    out = torch.empty_like(x)
    if m == 0 or d == 0:
        return out
    if x.is_meta:
        traced.record("rmsnorm", dict(m=m, d=d), x.dtype, x.device)
        return out
    err = build.entry("rmsnorm", f"rmsnorm_{build.SUFFIX[x.dtype]}")(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), m, d, float(eps),
        build.stream())
    build.check("rmsnorm", err)
    rmsnorm.launches += 1
    return out


# One-point tune space: the values a thread holds and the block sizes are
# compile-time in `csrc/rmsnorm.cu` (a knob for them is open work).
pipeline.register(pipeline.KernelDef(
    "rmsnorm", lambda s, knobs, db: pipeline.Traffic(
        flops=4.0 * s["m"] * s["d"],
        hbm_bytes=(2.0 * s["m"] * s["d"] + s["d"]) * db,
        ideal_bytes=(2.0 * s["m"] * s["d"] + s["d"]) * db, grid_steps=1,
        smem_bytes=0, peak_flops=hw.PEAK_FLOPS_F32),
    pipeline.one_point))

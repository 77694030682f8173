"""dotp — the paper's Table 1 `dotp`: wrapper, plain version, launch
count. Replaces `repro/kernels/dotp.py` _dotp_kernel / dotp; the kernel is
`csrc/dotp.cu` (bound and design in its notes).

The wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernel, or raises (see `fused.py` for the counting convention). A call is
one launch with no workspace (the kernel keeps its partial sums in its
library's device memory); its call path is lean as axpy's is.
"""

from __future__ import annotations

import torch

from . import build, pipeline, ref

F32 = torch.float32
BF16 = torch.bfloat16
DTYPES = (F32, BF16)
_launchers = None     # (dotp_f32, dotp_bf16), resolved at the first launch


def dotp_plain(x, y):
    """sum(f32(x) * f32(y)) as a 0-d f32 tensor."""
    if x.is_cuda:
        dotp_plain.cuda_calls += 1
    return ref.dotp(x, y)


def launchers() -> tuple:
    """The C launchers (f32, bf16), resolved once."""
    global _launchers
    if _launchers is None:
        _launchers = build.launcher("dotp", "dotp_f32", "dotp_bf16")
    return _launchers


def dotp(x, y):
    """x, y: same shape -> a 0-d f32 tensor on their device, whatever
    their dtype. Two runs on the card give the same bits."""
    if x.shape != y.shape:
        raise ValueError(f"dotp: shapes {tuple(x.shape)}, {tuple(y.shape)}")
    if not x.is_cuda:
        return dotp_plain(x, y)
    dev, (xp, yp) = build.check_operands("dotp", x, y, dtypes=DTYPES)
    out = x.new_empty((), dtype=F32)
    n = x.numel()
    if n == 0:
        return out.zero_()
    err = (_launchers or launchers())[x.dtype is BF16](
        xp, yp, out.data_ptr(), n, dev, build.stream(dev))
    if err:
        build.check("dotp", err)
    dotp.launches += 1
    return out


# One-point tune space: the launch plan is set by `csrc/stream.cuh`'s
# compile-time THREADS / UNROLL and the wave queried once per device.
pipeline.register(pipeline.KernelDef(
    "dotp", lambda s, knobs, db: pipeline.Traffic(
        flops=2.0 * s["m"] * s["n"], hbm_bytes=2.0 * s["m"] * s["n"] * db,
        ideal_bytes=2.0 * s["m"] * s["n"] * db, grid_steps=1, smem_bytes=0),
    pipeline.one_point))

"""axpy — the paper's Table 1 `axpy`: wrapper, plain version, launch
count. Replaces `repro/kernels/axpy.py` _axpy_kernel / axpy; the kernel is
`csrc/axpy.cu` (bound and design in its notes).

The wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernel, or raises (see `fused.py` for the counting convention). Its call
path is lean: the C launchers are resolved once and kept, the operands
checked in one pass (`build.check_operands`), the stream read as a raw
handle, and a Python-number alpha passed by value.
"""

from __future__ import annotations

import torch

from . import build, pipeline, ref

F32 = torch.float32
BF16 = torch.bfloat16
DTYPES = (F32, BF16)
_launchers = None     # (axpy_f32, axpy_bf16), resolved at the first launch


def axpy_plain(alpha, x, y):
    """f32(alpha) * f32(x) + f32(y), rounded to x.dtype."""
    if x.is_cuda:
        axpy_plain.cuda_calls += 1
    return ref.axpy(alpha, x, y)


def alpha_arg(alpha, x) -> tuple[int | None, float]:
    """alpha as the launcher takes it, (pointer, value): a 0-d or 1-element
    f32 tensor on x's device by its pointer (the kernel reads it: no host
    sync), anything else as a number, by value (pointer None: no
    allocation, no launch)."""
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1:
            raise ValueError(f"axpy: alpha holds {alpha.numel()} values")
        if alpha.dtype != F32 or alpha.get_device() != x.get_device():
            raise TypeError(f"axpy: alpha must be an f32 tensor on "
                            f"{x.device}, got {alpha.dtype} on "
                            f"{alpha.device}")
        return alpha.data_ptr(), 0.0
    return None, float(alpha)


def launchers() -> tuple:
    """The C launchers (f32, bf16), resolved once."""
    global _launchers
    if _launchers is None:
        _launchers = build.launcher("axpy", "axpy_f32", "axpy_bf16")
    return _launchers


def axpy(alpha, x, y):
    """alpha * x + y. x, y: same shape; alpha: a number or an f32 tensor
    of one value."""
    if x.shape != y.shape:
        raise ValueError(f"axpy: shapes {tuple(x.shape)}, {tuple(y.shape)}")
    if not x.is_cuda:
        return axpy_plain(alpha, x, y)
    dev, (xp, yp) = build.check_operands("axpy", x, y, dtypes=DTYPES)
    a_ptr, a_val = alpha_arg(alpha, x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    err = (_launchers or launchers())[x.dtype is BF16](
        a_ptr, a_val, xp, yp, out.data_ptr(), n, dev, build.stream(dev))
    if err:
        build.check("axpy", err)
    axpy.launches += 1
    return out


# One-point tune space: the launch plan is set by `csrc/stream.cuh`'s
# compile-time THREADS / UNROLL and the wave queried once per device.
pipeline.register(pipeline.KernelDef(
    "axpy", lambda s, knobs, db: pipeline.Traffic(
        flops=2.0 * s["m"] * s["n"], hbm_bytes=3.0 * s["m"] * s["n"] * db,
        ideal_bytes=3.0 * s["m"] * s["n"] * db, grid_steps=1, smem_bytes=0),
    pipeline.one_point))

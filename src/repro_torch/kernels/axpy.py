"""axpy — the paper's Table 1 `axpy`: wrapper, plain version, launch
count. Replaces `repro/kernels/axpy.py` _axpy_kernel / axpy; the kernel is
`csrc/axpy.cu` (bound and design in its notes).

The wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernel, or raises (see `fused.py` for the counting convention).
"""

from __future__ import annotations

import torch

from . import build, ref

F32 = torch.float32
DTYPES = (torch.float32, torch.bfloat16)


def axpy_plain(alpha, x, y):
    """f32(alpha) * f32(x) + f32(y), rounded to x.dtype."""
    if x.is_cuda:
        axpy_plain.cuda_calls += 1
    return ref.axpy(alpha, x, y)


def _alpha(alpha, device) -> torch.Tensor:
    """alpha as the 1-element f32 device tensor the kernel reads: a 0-d or
    1-element f32 tensor on `device` as it is (no host sync), a Python
    number written into a new one."""
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1:
            raise ValueError(f"axpy: alpha holds {alpha.numel()} values")
        if alpha.dtype != F32 or alpha.device != device:
            raise TypeError(f"axpy: alpha must be an f32 tensor on "
                            f"{device}, got {alpha.dtype} on {alpha.device}")
        return alpha
    return torch.full((1,), float(alpha), dtype=F32, device=device)


def axpy(alpha, x, y):
    """alpha * x + y. x, y: same shape; alpha: a number or an f32 tensor
    of one value."""
    if x.shape != y.shape:
        raise ValueError(f"axpy: shapes {tuple(x.shape)}, {tuple(y.shape)}")
    if not x.is_cuda:
        return axpy_plain(alpha, x, y)
    dev = build.check_operands("axpy", x, y, dtypes=DTYPES)
    a = _alpha(alpha, dev)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = build.entry("axpy", f"axpy_{build.SUFFIX[x.dtype]}")(
        a.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
        build.stream())
    build.check("axpy", err)
    axpy.launches += 1
    return out

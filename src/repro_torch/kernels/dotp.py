"""dotp — the paper's Table 1 `dotp`: wrapper, plain version, launch
count. Replaces `repro/kernels/dotp.py` _dotp_kernel / dotp; the kernel is
`csrc/dotp.cu` (bound and design in its notes).

The wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernel, or raises (see `fused.py` for the counting convention).
"""

from __future__ import annotations

import torch

from . import build, ref

DTYPES = (torch.float32, torch.bfloat16)


def dotp_plain(x, y):
    """sum(f32(x) * f32(y)) as a 0-d f32 tensor."""
    if x.is_cuda:
        dotp_plain.cuda_calls += 1
    return ref.dotp(x, y)


def dotp(x, y):
    """x, y: same shape -> a 0-d f32 tensor on their device, whatever
    their dtype. Two runs on the card give the same bits."""
    if x.shape != y.shape:
        raise ValueError(f"dotp: shapes {tuple(x.shape)}, {tuple(y.shape)}")
    if not x.is_cuda:
        return dotp_plain(x, y)
    build.check_operands("dotp", x, y, dtypes=DTYPES)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    n = x.numel()
    if n == 0:
        return out.zero_()
    ws = build.workspace("dotp", x.device, n)
    err = build.entry("dotp", f"dotp_{build.SUFFIX[x.dtype]}")(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), ws.data_ptr(), n,
        build.stream())
    build.check("dotp", err)
    dotp.launches += 1
    return out

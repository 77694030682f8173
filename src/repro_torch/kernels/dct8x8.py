"""dct8x8 — the paper's Table 1 `dct`: wrapper, plain version, launch
count. Replaces `repro/kernels/dct8x8.py` _dct_kernel / dct8x8; the kernel
is `csrc/dct8x8.cu` (bound and design in its notes).

The kernel and the plain version use the same coefficients, `ref.dct_matrix(8)`,
which the wrapper passes to the kernel as an (8, 8) f32 operand. The
wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernel, or raises (see `fused.py` for the counting convention).
"""

from __future__ import annotations

import torch

from repro_torch.core import mesh as hw

from . import build, pipeline, ref

F32 = torch.float32
_C = torch.from_numpy(ref.dct_matrix(8))
_C_ON: dict[torch.device, torch.Tensor] = {}    # the matrix on each device


def _c(device) -> torch.Tensor:
    c = _C_ON.get(device)
    if c is None:
        c = _C_ON[device] = _C.to(device)
    return c


def dct8x8_plain(blocks):
    """C (X C^T) per block in f32 — the kernel's two products, in its
    order — rounded to blocks.dtype."""
    if blocks.is_cuda:
        dct8x8_plain.cuda_calls += 1
    c = _c(blocks.device)
    return (c @ (blocks.to(F32) @ c.T)).to(blocks.dtype)


def dct8x8(blocks):
    """blocks: (N, 8, 8) -> the 2-D DCT of each block. f32 on CUDA."""
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (8, 8):
        raise ValueError(f"dct8x8: shape {tuple(blocks.shape)}, expected "
                         f"(N, 8, 8)")
    if not blocks.is_cuda:
        return dct8x8_plain(blocks)
    build.check_operands("dct8x8", blocks, dtypes=(F32,))
    out = torch.empty_like(blocks)
    n = blocks.shape[0]
    if n == 0:
        return out
    err = build.entry("dct8x8", "dct8x8_f32")(
        blocks.data_ptr(), _c(blocks.device).data_ptr(), out.data_ptr(), n,
        build.stream())
    build.check("dct8x8", err)
    dct8x8.launches += 1
    return out


# One-point tune space: THREADS and the blocks a step are compile-time in
# `csrc/dct8x8.cu`.
pipeline.register(pipeline.KernelDef(
    "dct8x8", lambda s, knobs, db: pipeline.Traffic(
        flops=4.0 * s["n"] * 8 ** 3, hbm_bytes=2.0 * s["n"] * 64 * db,
        ideal_bytes=2.0 * s["n"] * 64 * db, grid_steps=1, smem_bytes=0,
        peak_flops=hw.PEAK_FLOPS_F32),
    pipeline.one_point))

"""conv2d_3x3 — the paper's Table 1 `2dconv`: wrapper, plain version,
launch count. Replaces `repro/kernels/conv2d.py` _conv_kernel /
conv2d_3x3; the kernel is `csrc/conv2d.cu` (bound and design in its
notes).

The wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernel, or raises (see `fused.py` for the counting convention).
"""

from __future__ import annotations

import torch

from repro_torch.core import mesh as hw

from . import build, pipeline, ref


def conv2d_3x3_plain(x, w):
    """Zero-padded 'same' 3x3 correlation in f32, the nine products summed
    dy outer, dx inner, from 0 (the kernel's order), rounded to x.dtype."""
    if x.is_cuda:
        conv2d_3x3_plain.cuda_calls += 1
    return ref.conv2d_3x3(x, w)


def conv2d_3x3(x, w):
    """x: (H, W); w: (3, 3) -> (H, W). f32 on CUDA."""
    if x.dim() != 2 or tuple(w.shape) != (3, 3):
        raise ValueError(f"conv2d_3x3: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if not x.is_cuda:
        return conv2d_3x3_plain(x, w)
    build.check_operands("conv2d", x, w, dtypes=(torch.float32,))
    h, wd = x.shape
    out = torch.empty_like(x)
    if h == 0 or wd == 0:
        return out
    err = build.entry("conv2d", "conv2d_3x3_f32")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), h, wd, build.stream())
    build.check("conv2d", err)
    conv2d_3x3.launches += 1
    return out


# One-point tune space: the tile (TW x TH, TY rows a thread) is
# compile-time in `csrc/conv2d.cu`.
pipeline.register(pipeline.KernelDef(
    "conv2d", lambda s, knobs, db: pipeline.Traffic(
        flops=18.0 * s["h"] * s["w"], hbm_bytes=2.0 * s["h"] * s["w"] * db,
        ideal_bytes=2.0 * s["h"] * s["w"] * db, grid_steps=1, smem_bytes=0,
        peak_flops=hw.PEAK_FLOPS_F32),
    pipeline.one_point))

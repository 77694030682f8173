"""matmul — the paper's Table 1 `matmul`: wrapper, plain version, launch
count. Replaces `repro/kernels/matmul.py` _matmul_kernel / matmul;
the kernel is `csrc/matmul.cu` (bound and design in its notes). f32 with
K and N multiples of 4 runs as three TF32 products on the tensor cores
(`csrc/tf32x3_gemm.cuh`: a split pass of b into the workspace, then the
product, or at M <= 256 one product that splits b itself;
`ref.matmul_tf32x3` emulates its arithmetic); other f32 shapes on the
CUDA cores.

The wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernel, or raises (see `fused.py` for the counting convention). Its
keywords pin the kernel's plan for the tuning layer (`gemm_plans.py`):
``tile_n`` the bf16 mainloop's N tile or the 3xTF32 product's,
``boxes`` / ``cluster`` the bf16 decode kernel's plan, ``cluster`` the
3xTF32 product's; 0 leaves the kernel its own pick, and a pin the shape's
kernel cannot take raises. The plain version ignores them.
"""

from __future__ import annotations

import torch

from repro_torch.device import on_card

from . import build, gemm_plans, pipeline, ref, traced

DTYPES = (torch.float32, torch.bfloat16)


def matmul_plain(a, b, **_knobs):
    """a @ b with an f32 accumulator, rounded once to a.dtype."""
    traced.count_plain(matmul_plain, a)
    return ref.matmul(a, b)


def matmul(a, b, *, tile_n: int = 0, boxes: int = 0, cluster: int = 0):
    """a: (M, K) @ b: (K, N) -> (M, N) in a.dtype (f32 or bf16 on CUDA)."""
    m, k = a.shape
    if b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"matmul: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if not on_card(a):
        return matmul_plain(a, b)
    build.check_operands("matmul", a, b, dtypes=DTYPES)
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    if a.is_meta:
        traced.record("matmul", dict(m=m, k=k, n=n), a.dtype, a.device,
                      (m, n, k, int(a.dtype == torch.float32)))
        return out
    ws = build.workspace("matmul", a.device, m, n, k,
                         int(a.dtype == torch.float32))
    err = build.entry("matmul", f"matmul_{build.SUFFIX[a.dtype]}")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), m, n, k,
        tile_n, boxes, cluster, build.stream())
    build.check("matmul", err)
    matmul.launches += 1
    return out


def _traffic(shapes: dict, knobs: dict, dtype_bytes: int):
    return gemm_plans.traffic(shapes["m"], shapes["k"], shapes["n"],
                              dtype_bytes, knobs)


pipeline.register(pipeline.KernelDef(
    "matmul", _traffic,
    lambda s, db: gemm_plans.space(s["m"], s["k"], s["n"], db),
    own_plan=lambda s, db: gemm_plans.own_plan("matmul", s["m"], s["k"],
                                               s["n"], db)))

"""Hardware constants of the NVIDIA H100 SXM — the port's counterpart of
the constants at the top of `repro.core.mesh` (which are a TPU v5e's).

Every number is the H100 SXM data sheet's; `launch/roofline.py`, the
tuning layer's cost model (`kernels/pipeline.score`) and `chip_smoke.py`'s
bounds read them from here, so there is one copy. The topology half of
the reference module (levels, meshes, collectives) belongs to the groups
slice (ROADMAP Queue 1 I).
"""

from __future__ import annotations

SMS = 132                          # streaming multiprocessors
SMEM_PER_BLOCK = 227 * 1024        # shared memory a block may opt in to
L2_BYTES = 50 * 1024**2            # L2 cache
HBM_BYTES = 80 * 1000**3           # device memory (80 GB)
HBM_BW = 3.35e12                   # B/s
PEAK_FLOPS_BF16 = 989e12           # dense bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12           # dense TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12             # f32 on the CUDA cores

# the peak of each operand type a kernel's products run at
PEAKS = {"bf16": PEAK_FLOPS_BF16, "tf32": PEAK_FLOPS_TF32,
         "f32": PEAK_FLOPS_F32}

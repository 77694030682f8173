"""Roofline terms of one kernel invocation on the H100 — the port's
counterpart of `repro.launch.roofline.kernel_roofline` / `fused_roofline`
(the reference's dry-run table renderers read XLA dumps and stay there).

The constants come from `core/mesh.py`. A kernel's operations run at the
peak of their operand type: bf16 on the tensor cores, TF32 for the f32
matmul's 3xTF32 route (count its three products in `flops`), or f32 on
the CUDA cores.
"""

from __future__ import annotations

from repro_torch.core import mesh as hw


def kernel_roofline(flops: float, hbm_bytes: float,
                    peak_flops: float = hw.PEAK_FLOPS_BF16) -> dict:
    """Roofline terms (seconds) of one kernel invocation on one card."""
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / hw.HBM_BW
    intensity = flops / max(hbm_bytes, 1.0)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "dominant": "compute_s" if compute_s >= memory_s else "memory_s",
        "intensity": intensity,
        "roof_flops": min(peak_flops, intensity * hw.HBM_BW),
    }


def fused_roofline(flops: float, hbm_bytes: float, saved_bytes: float,
                   peak_flops: float = hw.PEAK_FLOPS_BF16) -> dict:
    """Roofline of a fused kernel with the dropped intermediate made
    explicit: the unfused composition would stream `hbm_bytes +
    saved_bytes` (the intermediate's write and read)."""
    r = kernel_roofline(flops, hbm_bytes, peak_flops)
    unfused = kernel_roofline(flops, hbm_bytes + saved_bytes, peak_flops)
    r.update({
        "saved_bytes": saved_bytes,
        "saved_s": saved_bytes / hw.HBM_BW,
        "unfused_memory_s": unfused["memory_s"],
        "traffic_reduction": (hbm_bytes + saved_bytes) / max(hbm_bytes, 1.0),
    })
    return r

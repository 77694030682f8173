"""Launch accounting for every kernel of the port, in one place.

Each wrapper counts the launches it makes in ``<wrapper>.launches``; each
plain version counts the calls it served with CUDA tensors in
``<plain>.cuda_calls``. `reset_counts` sets all of them to 0, `counts`
reads them, and `traced_launches` counts each kernel's device runs in a
torch.profiler trace, which also sees the launches a replayed CUDA graph
makes (the wrappers do not run then); `launch_counts` does the same from
the raw device records `device_kernels` reads, for traces too long to
parse.
"""

from __future__ import annotations

from . import axpy as _axpy
from . import conv2d as _conv2d
from . import dct8x8 as _dct8x8
from . import dotp as _dotp
from . import flash_attention as _fa
from . import fused as _fused
from . import gemm_plans
from . import matmul as _matmul
from . import rmsnorm as _rmsnorm

WRAPPERS = {"rmsnorm_matmul": _fused.rmsnorm_matmul,
            "matmul_residual_add": _fused.matmul_residual_add,
            "flash_attention_proj": _fused.flash_attention_proj,
            "matmul": _matmul.matmul,
            "axpy": _axpy.axpy,
            "dotp": _dotp.dotp,
            "conv2d": _conv2d.conv2d_3x3,
            "dct8x8": _dct8x8.dct8x8,
            "rmsnorm": _rmsnorm.rmsnorm,
            "flash_attention": _fa.flash_attention,
            "matmul_bias_act": _fused.matmul_bias_act}
PLAIN = {"rmsnorm_matmul": _fused.rmsnorm_matmul_plain,
         "matmul_residual_add": _fused.matmul_residual_add_plain,
         "flash_attention_proj": _fused.flash_attention_proj_plain,
         "matmul": _matmul.matmul_plain,
         "axpy": _axpy.axpy_plain,
         "dotp": _dotp.dotp_plain,
         "conv2d": _conv2d.conv2d_3x3_plain,
         "dct8x8": _dct8x8.dct8x8_plain,
         "rmsnorm": _rmsnorm.rmsnorm_plain,
         "flash_attention": _fa.flash_attention_plain,
         "matmul_bias_act": _fused.matmul_bias_act_plain}
FUSED = ("rmsnorm_matmul", "matmul_residual_add", "flash_attention_proj",
         "matmul_bias_act")
SUITE = ("matmul", "axpy", "dotp", "conv2d", "dct8x8")


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in PLAIN.values():
        fn.cuda_calls = 0


def counts() -> dict:
    """{name: {"launches": n, "plain_cuda_calls": n}} since the last
    `reset_counts()`."""
    return {name: {"launches": WRAPPERS[name].launches,
                   "plain_cuda_calls": PLAIN[name].cuda_calls}
            for name in WRAPPERS}


# The Hopper mainloop's N tiles (`hopper::TILE_N`, mirrored in
# gemm_plans.py) and the OWNER argument each wrapper instantiates it with
# (`hopper::OWNER_*`, csrc/wgmma_gemm.cuh).
TILE_N = gemm_plans.TILE_N
MAINLOOP_OWNER = {"rmsnorm_matmul": 0, "flash_attention_proj": 1,
                  "matmul": 2, "matmul_residual_add": 3,
                  "matmul_bias_act": 4}


def _mainloop(wrapper: str, epi: int) -> tuple:
    """The profiler names of `wrapper`'s mainloop instantiations, one a
    BN: `hopper::tma_wgmma_kernel<BN,EPI,OWNER>`."""
    return tuple(f"hopper::tma_wgmma_kernel<{bn},{epi},"
                 f"{MAINLOOP_OWNER[wrapper]}>" for bn in TILE_N)


# The device kernel that opens each launch of a wrapper (a split-K finish
# or the wgmma mainloop may follow it; axpy and dotp run one kernel a
# call), as a profiler names it, spaces removed. The five matmul entry
# points instantiate the same templates with other flags (<prologue,
# epilogue code>, common.cuh and decode_gemm.cuh; <BN, epilogue code,
# owner>, wgmma_gemm.cuh), so each has names of its own: the M <= 16
# products run `decode::tma_gemv_kernel<NORM,EPI>` (one launch a call),
# and only shapes with K or N % 8 != 0 run common.cuh's split-K pair. matmul's,
# matmul_residual_add's and matmul_bias_act's M > 16 calls open with the
# mainloop, counted by their own instantiations;
# rmsnorm_matmul's and flash_attention_proj's open with a kernel of their
# own (the row normalisation, the per-head attention), which counts them,
# and their mainloop instantiations are named by no pattern. matmul's f32
# calls with K, N % 4 == 0 open with `tf32x3::split_kernel` (its product,
# `tf32x3::gemm_kernel<BN>`, is named by no pattern) or, at M <= 256, run
# `tf32x3::fused_kernel<BN>` alone; other f32 calls run
# `sgemm::matmul_f32_kernel` alone.
ENTRY_KERNELS = {
    "rmsnorm_matmul": ("decode::tma_gemv_kernel<true,0>",
                       "skinny::partial_kernel<true,0>",
                       "gemm::tile_kernel<true,0>", "norm_rows_kernel"),
    "matmul_residual_add": ("decode::tma_gemv_kernel<false,1>",
                            "skinny::partial_kernel<false,1>",
                            "gemm::tile_kernel<false,1>",
                            *_mainloop("matmul_residual_add", 1)),
    "flash_attention_proj": ("fa_proj_heads_kernel",),
    "matmul": ("decode::tma_gemv_kernel<false,0>",
               "skinny::partial_kernel<false,0>",
               "gemm::tile_kernel<false,0>", "matmul_f32_kernel",
               "tf32x3::split_kernel", "tf32x3::fused_kernel<",
               *_mainloop("matmul", 0)),
    "axpy": ("axpy_kernel<",),
    "dotp": ("dotp_kernel<",),
    "conv2d": ("conv2d_3x3_kernel",),
    "dct8x8": ("dct8x8_kernel",),
    "rmsnorm": ("rmsnorm_kernel<",),
    "flash_attention": ("flash_attention_kernel<",),
    "matmul_bias_act": (*(f"{path}<false,{epi}>"
                          for path in ("decode::tma_gemv_kernel",
                                       "skinny::partial_kernel",
                                       "gemm::tile_kernel")
                          for epi in (2, 3, 4)),
                        *(k for epi in (2, 3, 4)
                          for k in _mainloop("matmul_bias_act", epi))),
}


def traced_launches(prof) -> dict:
    """{name: n}: how often each wrapper's kernel ran on the device in the
    torch.profiler trace `prof`, counted by its entry kernel."""
    return launch_counts({e.key: e.count for e in prof.key_averages()
                          if "CUDA" in str(getattr(e, "device_type", ""))})


def device_kernels(prof) -> dict:
    """{device kernel name: runs} read from the profiler's raw records,
    without the Python event tree that `key_averages` builds first: for a
    trace of a few hundred thousand kernels that parse is most of the
    trace's cost."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            out[e.name()] = out.get(e.name(), 0) + 1
    return out


def launch_counts(kernels: dict) -> dict:
    """{name: n} from {device kernel name: runs}: each wrapper's launches,
    counted by its entry kernel."""
    out = dict.fromkeys(WRAPPERS, 0)
    for kernel, runs in kernels.items():
        key = kernel.replace(" ", "")
        for name, entries in ENTRY_KERNELS.items():
            if any(k in key for k in entries):
                out[name] += runs
    return out


reset_counts()

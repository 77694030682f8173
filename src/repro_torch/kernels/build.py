"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and becomes its own
shared library, `build/repro_torch/<name>-<hash>.so` under the repository
root (or `REPRO_TORCH_BUILD_DIR`). The hash covers the sources and the
flags, so an edit rebuilds and a stale library is never loaded. All
missing libraries are built by parallel nvcc processes on the first call
to `library()`; nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rmsnorm_matmul", "matmul_residual_add", "flash_attention_proj",
           "matmul", "axpy", "dotp", "conv2d", "dct8x8", "rmsnorm",
           "matmul_bias_act", "flash_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
SZ = ctypes.c_size_t
# the C functions of each library: name -> (argtypes, restype). Launchers
# (one per dtype, `<name>_<f32|bf16>`) return cudaGetLastError();
# *_workspace_floats size the f32 scratch the wrapper allocates (split-K
# partials, the bf16 operands the wgmma paths stage, f32 matmul's split of
# b); axpy and dotp take the device index before the stream and export
# `<name>_grid` (n, 1 for bf16, device: the blocks a launch takes). The
# four GEMM launchers take the pinned plan (tile_n, boxes, cluster) before
# the stream, flash_attention_proj its projection's tile_n (0: the
# kernel's own pick; a pin the kernel cannot take is an error). matmul
# also exports `matmul_f32_plan` (M, N, K, tile_n, cluster, int[7] out:
# the f32 route and its tile, cluster, tiles, blocks, k a block, stages);
# the libraries that include csrc/wgmma_gemm.cuh also export `wgmma_plan`
# (M, N, tile_n, int[3] out: the mainloop's BN, tiles and blocks), and the
# four GEMM wrappers `<name>_decode_plan` (M, N, K, boxes, cluster, int[5]
# out: the decode kernel's N tile, cluster size, CTAs, k rows a CTA,
# stages). The plan reports take the same pins as the launches.
WGMMA_PLAN = {"wgmma_plan": ([I, I, I, P], I)}
PINS = [I, I, I]                  # tile_n, boxes, cluster


def _decode_plan(name: str) -> dict:
    return {f"{name}_decode_plan": ([I, I, I, I, I, P], I)}


SIGNATURES = {
    "rmsnorm_matmul": {
        "rmsnorm_matmul_bf16": ([P, P, P, P, P, I, I, I, F, *PINS, P], I),
        "rmsnorm_matmul_workspace_floats": ([I, I, I], SZ), **WGMMA_PLAN,
        **_decode_plan("rmsnorm_matmul")},
    "matmul_residual_add": {
        "matmul_residual_add_bf16": (
            [P, P, P, P, P, I, I, I, *PINS, P], I),
        "matmul_residual_add_workspace_floats": ([I, I, I], SZ),
        **WGMMA_PLAN, **_decode_plan("matmul_residual_add")},
    "flash_attention_proj": {
        "flash_attention_proj_bf16": (
            [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P], I),
        "flash_attention_proj_workspace_floats": ([I, I, I, I], SZ),
        **WGMMA_PLAN},
    "matmul": {
        "matmul_f32": ([P, P, P, P, I, I, I, *PINS, P], I),
        "matmul_bf16": ([P, P, P, P, I, I, I, *PINS, P], I),
        "matmul_workspace_floats": ([I, I, I, I], SZ),
        "matmul_f32_plan": ([I, I, I, I, I, P], I),
        **WGMMA_PLAN, **_decode_plan("matmul")},
    "axpy": {
        "axpy_f32": ([P, F, P, P, P, SZ, I, P], I),
        "axpy_bf16": ([P, F, P, P, P, SZ, I, P], I),
        "axpy_grid": ([SZ, I, I], I)},
    "dotp": {
        "dotp_f32": ([P, P, P, SZ, I, P], I),
        "dotp_bf16": ([P, P, P, SZ, I, P], I),
        "dotp_grid": ([SZ, I, I], I)},
    "conv2d": {"conv2d_3x3_f32": ([P, P, P, I, I, P], I)},
    "dct8x8": {"dct8x8_f32": ([P, P, P, SZ, P], I)},
    "rmsnorm": {
        "rmsnorm_f32": ([P, P, P, I, I, F, P], I),
        "rmsnorm_bf16": ([P, P, P, I, I, F, P], I)},
    "matmul_bias_act": {
        "matmul_bias_act_bf16": (
            [P, P, P, P, P, I, I, I, I, *PINS, P], I),
        "matmul_bias_act_workspace_floats": ([I, I, I], SZ),
        **WGMMA_PLAN, **_decode_plan("matmul_bias_act")},
    "flash_attention": {
        "flash_attention_bf16": ([P, P, P, P, I, I, I, I, I, I, F, P], I)},
}


_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None        # wall time of the last build


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built on first use")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict[str, Path]:
    """Compile every library in `names` that is missing, one nvcc process
    per source, all started together. Returns {name: path}."""
    global build_seconds
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    t0 = time.perf_counter()
    if todo:
        exe = nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [exe, *FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
                   "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {n} (exit {proc.returncode})\n{log}")
                continue
            if verbose:
                print(f"--- nvcc {n}\n{log}", flush=True)
            os.replace(tmp, out[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building all sources first
    if any is missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build()
            for n, path in paths.items():
                if n in _LIBS:
                    continue
                handle = ctypes.CDLL(str(path))
                for fn_name, (argtypes, restype) in SIGNATURES[n].items():
                    fn = getattr(handle, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                _LIBS[n] = handle
            lib = _LIBS[name]
        return lib


def entry(name: str, fn: str | None = None):
    """C function `fn` (default: the launcher `<name>_bf16`) of kernel
    `name`'s library, with argtypes and restype declared."""
    return getattr(library(name), fn or f"{name}_bf16")


def check(name: str, err: int) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        fn = library(name).repro_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({fn(err).decode()})")


# ----------------------------------------------------------------------------
# what every wrapper does around a launch
# ----------------------------------------------------------------------------

SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def stream(device: int | None = None) -> int:
    """The current CUDA stream of `device` (an index; default the current
    device) as the launchers take it: its raw handle, read without building
    a torch.cuda.Stream."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if device is None else device)


def launcher(name: str, *fns: str) -> tuple:
    """C functions `fns` of kernel `name`'s library, for a wrapper to keep:
    resolved once, they are called with no lock or lookup."""
    lib = library(name)
    return tuple(getattr(lib, fn) for fn in fns)


def workspace(name: str, device, *sizes: int) -> torch.Tensor:
    """The f32 scratch kernel `name` asks for at these sizes (its C
    function `<name>_workspace_floats`); one element when it needs none."""
    floats = entry(name, f"{name}_workspace_floats")(*sizes)
    return torch.empty(max(int(floats), 1), dtype=torch.float32,
                       device=device)


def check_operands(name: str, *tensors: torch.Tensor,
                   dtypes=(torch.bfloat16,)) -> tuple[int, list[int]]:
    """Raise unless the operands share one device and a dtype of `dtypes`
    (nothing is cast) and are contiguous and 32-byte aligned; return the
    device's index and the operands' data pointers. Operands that pass
    take one lean pass; the detailed one runs only to say what is wrong.
    An operand that requires grad, with grad on, raises too: a launch
    carries no gradient, so the op must run inside its autograd Function
    (`ops.py`), which launches with grad off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an operand requires grad, and a kernel launch would "
            f"return a result with none; call the op through "
            f"repro_torch.kernels.ops (its autograd Function) or under "
            f"torch.no_grad()")
    first = tensors[0]
    dev, dt = first.get_device(), first.dtype
    ok, ptrs = dt in dtypes, []
    for t in tensors:
        p = t.data_ptr()
        ptrs.append(p)
        ok = (ok and not p & 31 and t.dtype is dt and t.get_device() == dev
              and t.is_contiguous())
    if ok:
        return dev, ptrs
    if dt not in dtypes:
        raise TypeError(f"{name}: the CUDA kernel takes "
                        f"{' or '.join(map(str, dtypes))}, got {dt}")
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{first.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: operands of {t.dtype} and {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{name}: operands must be 32-byte aligned")
    return dev, ptrs

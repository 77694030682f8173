"""Policy-dispatched kernel ops — the port's `repro.kernels.ops`: the
paper's Table 1 suite (`matmul`, `axpy`, `dotp`, `conv2d_3x3`, `dct8x8`),
`rmsnorm` and `flash_attention`, and the four fused kernels (forward
only; the custom-VJP backward comes with the training slice).

Under the active `KernelPolicy`:

  * mode "reference" -> the plain oracle (`kernels/ref.py`);
  * mode "interpret" -> the kernel's plain PyTorch version;
  * otherwise        -> the kernel wrapper: the Hopper kernel for CUDA
                        tensors, its plain version for CPU tensors.

The block arguments (``bm``/``bn``/``bk``, ``block_rows``, ``block_n``,
``bq``/``bk``; `REFERENCE_BLOCKS`) are the reference's Pallas grid
blocking. Outside the "reference" mode they are checked as the reference
checks them (an explicit block, capped at its dimension, must divide it)
and are passed to no kernel. The GEMM ops also take the Hopper kernels'
own plan knobs (``tile_n``; ``boxes`` and ``cluster``; see
`kernels/pipeline.py`), which they pass to the kernel: 0 leaves it its
own pick, a pin it cannot take raises, and the plain versions ignore them.

Every ported kernel registers one `OpDescriptor` in `OPS`, under the
reference's name (the convolution is "conv2d"). Each fused op's
`composition` is its unfused route, built from the policy-dispatched
primitives (`rmsnorm`, `matmul`, `flash_attention`) with PyTorch
epilogues, as the reference's `_comp_*` are. `tuned_call` runs an op under
`KernelPolicy.call`: a pinned plan, or the tuned one (registry-cached,
raced on a miss against the kernel's own plan and, for a fused op, its
composition).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.cluster.policy import current_policy
from repro_torch.device import resolve_device

from . import axpy as _axpy
from . import conv2d as _conv2d
from . import dct8x8 as _dct8x8
from . import dotp as _dotp
from . import flash_attention as _fa
from . import fused as _fused
from . import matmul as _matmul
from . import ref as _ref
from . import rmsnorm as _rmsnorm

F32 = torch.float32


def _route(name: str) -> str:
    pol = current_policy()
    mode = pol.mode_for(name)
    if mode == "reference":
        pol.bump("ref_calls")
        return "reference"
    if mode == "interpret":
        pol.bump("plain_calls")
        return "plain"
    pol.bump("kernel_calls")
    return "kernel"


def _check_blocks(**dims_and_blocks: tuple[int, int | None]) -> None:
    """The reference's `pipeline.resolve_block` check on each (dim,
    block): None passes, an explicit block is capped at its dimension and
    must then divide it."""
    for what, (dim, block) in dims_and_blocks.items():
        if block is None:
            continue
        b = max(1, min(block, dim))
        if dim % b:
            raise ValueError(
                f"block size {b} ({what}) does not divide dimension {dim}; "
                f"pass a divisor or omit it for the snapped default")


# the reference's Pallas block keywords of each op (checked, never passed on)
REFERENCE_BLOCKS = {
    "matmul": ("bm", "bn", "bk"), "axpy": ("block_rows",),
    "dotp": ("block_rows",), "conv2d": ("block_rows",),
    "dct8x8": ("block_n",), "rmsnorm": ("block_rows",),
    "flash_attention": ("bq", "bk"), "rmsnorm_matmul": ("bm", "bn"),
    "matmul_bias_act": ("bm", "bn", "bk"),
    "matmul_residual_add": ("bm", "bn", "bk"),
    "flash_attention_proj": ("bq", "bk")}


# ----------------------------------------------------------------------------
# The paper's Table 1 suite
# ----------------------------------------------------------------------------

def matmul(a, b, *, bm: int | None = None, bn: int | None = None,
           bk: int | None = None, tile_n: int = 0, boxes: int = 0,
           cluster: int = 0):
    """a (M, K) @ b (K, N), f32 accumulator, output in a.dtype."""
    route = _route("matmul")
    if route == "reference":
        return _ref.matmul(a, b)
    _check_blocks(bm=(a.shape[0], bm), bn=(b.shape[1], bn),
                  bk=(a.shape[1], bk))
    if route == "plain":
        return _matmul.matmul_plain(a, b)
    return _matmul.matmul(a, b, tile_n=tile_n, boxes=boxes, cluster=cluster)


def axpy(alpha, x, y, *, block_rows: int | None = None):
    """alpha * x + y in f32, output in x.dtype; x, y: (M, N)."""
    route = _route("axpy")
    if route == "reference":
        return _ref.axpy(alpha, x, y)
    _check_blocks(block_rows=(x.shape[0], block_rows))
    if route == "plain":
        return _axpy.axpy_plain(alpha, x, y)
    return _axpy.axpy(alpha, x, y)


def dotp(x, y, *, block_rows: int | None = None):
    """sum(x * y) in f32 as a 0-d f32 tensor; x, y: (M, N)."""
    route = _route("dotp")
    if route == "reference":
        return _ref.dotp(x, y)
    _check_blocks(block_rows=(x.shape[0], block_rows))
    if route == "plain":
        return _dotp.dotp_plain(x, y)
    return _dotp.dotp(x, y)


def conv2d_3x3(x, w, *, block_rows: int | None = None):
    """Zero-padded 'same' 3x3 correlation; x: (H, W), w: (3, 3)."""
    route = _route("conv2d")
    if route == "reference":
        return _ref.conv2d_3x3(x, w)
    _check_blocks(block_rows=(x.shape[0], block_rows))
    if route == "plain":
        return _conv2d.conv2d_3x3_plain(x, w)
    return _conv2d.conv2d_3x3(x, w)


def dct8x8(blocks, *, block_n: int | None = None):
    """The 2-D DCT C X C^T of each block of (N, 8, 8)."""
    route = _route("dct8x8")
    if route == "reference":
        return _ref.dct8x8(blocks)
    _check_blocks(block_n=(blocks.shape[0], block_n))
    if route == "plain":
        return _dct8x8.dct8x8_plain(blocks)
    return _dct8x8.dct8x8(blocks)


def rmsnorm(x, scale, *, block_rows: int | None = None):
    """x * rsqrt(mean(x^2) + 1e-6) * (1 + scale) per row; x: (M, D)."""
    route = _route("rmsnorm")
    if route == "reference":
        return _ref.rmsnorm(x, scale)
    _check_blocks(block_rows=(x.shape[0], block_rows))
    if route == "plain":
        return _rmsnorm.rmsnorm_plain(x, scale)
    return _rmsnorm.rmsnorm(x, scale)


def _ref_flash_attention(q, k, v, *, causal: bool = True):
    g = q.shape[1] // k.shape[1]
    return _ref.flash_attention(q, k.repeat_interleave(g, dim=1),
                                v.repeat_interleave(g, dim=1), causal=causal)


def flash_attention(q, k, v, *, causal: bool = True, bq: int | None = None,
                    bk: int | None = None):
    """Attention, causal or full, GQA head h -> kv head h // (H/KV).
    q: (B, H, S, hd); k/v: (B, KV, S, hd)."""
    route = _route("flash_attention")
    if route == "reference":
        return _ref_flash_attention(q, k, v, causal=causal)
    _check_blocks(bq=(q.shape[2], bq), bk=(q.shape[2], bk))
    if route == "plain":
        return _fa.flash_attention_plain(q, k, v, causal)
    return _fa.flash_attention(q, k, v, causal)


# ----------------------------------------------------------------------------
# The fused kernels
# ----------------------------------------------------------------------------

def rmsnorm_matmul(x, scale, w, *, bm: int | None = None,
                   bn: int | None = None, tile_n: int = 0, boxes: int = 0,
                   cluster: int = 0):
    """matmul(rmsnorm(x, scale), w); the normed x never round-trips HBM."""
    route = _route("rmsnorm_matmul")
    if route == "reference":
        return _ref.rmsnorm_matmul(x, scale, w)
    if bm is not None or bn is not None:
        _check_blocks(bm=(x.shape[0], bm), bn=(w.shape[1], bn))
    if route == "plain":
        return _fused.rmsnorm_matmul_plain(x, scale, w)
    return _fused.rmsnorm_matmul(x, scale, w, tile_n=tile_n, boxes=boxes,
                                 cluster=cluster)


def matmul_bias_act(a, b, bias, *, act: str = "gelu", bm: int | None = None,
                    bn: int | None = None, bk: int | None = None,
                    tile_n: int = 0, boxes: int = 0, cluster: int = 0):
    """act(a @ b + bias) with the epilogue applied before writeback."""
    route = _route("matmul_bias_act")
    if route == "reference":
        return _ref.matmul_bias_act(a, b, bias, act)
    if bm is not None or bn is not None or bk is not None:
        _check_blocks(bm=(a.shape[0], bm), bn=(b.shape[1], bn),
                      bk=(a.shape[1], bk))
    if route == "plain":
        return _fused.matmul_bias_act_plain(a, b, bias, act)
    return _fused.matmul_bias_act(a, b, bias, act, tile_n=tile_n,
                                  boxes=boxes, cluster=cluster)


def matmul_residual_add(a, b, res, *, bm: int | None = None,
                        bn: int | None = None, bk: int | None = None,
                        tile_n: int = 0, boxes: int = 0, cluster: int = 0):
    """a @ b + res; the matmul output never round-trips HBM."""
    route = _route("matmul_residual_add")
    if route == "reference":
        return _ref.matmul_residual_add(a, b, res)
    if bm is not None or bn is not None or bk is not None:
        _check_blocks(bm=(a.shape[0], bm), bn=(b.shape[1], bn),
                      bk=(a.shape[1], bk))
    if route == "plain":
        return _fused.matmul_residual_add_plain(a, b, res)
    return _fused.matmul_residual_add(a, b, res, tile_n=tile_n, boxes=boxes,
                                      cluster=cluster)


def flash_attention_proj(q, k, v, wo, *, causal: bool = True,
                         bq: int | None = None, bk: int | None = None,
                         tile_n: int = 0):
    """Flash attention with the output projection fused across heads."""
    route = _route("flash_attention_proj")
    if route == "reference":
        return _ref.flash_attention_proj(q, k, v, wo, causal=causal)
    if bq is not None or bk is not None:
        _check_blocks(bq=(q.shape[2], bq), bk=(q.shape[2], bk))
    if route == "plain":
        return _fused.flash_attention_proj_plain(q, k, v, wo, causal)
    return _fused.flash_attention_proj(q, k, v, wo, causal, tile_n=tile_n)


# ----------------------------------------------------------------------------
# Kernel descriptor table — one record per ported kernel
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpDescriptor:
    """A kernel's public contract in one place (the reference's).

    `shapes(*operands)` maps the wrapper's operands to the reference's
    pipeline-layer shape dict; `operands(shapes, dtype, device=None)` is
    its inverse, seeded random operands on `device` (the GPU unless
    given); `reference` is the oracle the "reference" mode routes to;
    `streamed_operand` is the index of the operand whose dtype sets the
    tile footprint; `fused` marks the producer-consumer kernels, and
    `composition` is a fused kernel's unfused route: the same math from
    the primitive wrappers plus PyTorch epilogues (not the `reference`
    oracle), the fusion's opponent in the tuning layer's race.
    """

    name: str
    wrapper: Callable
    shapes: Callable[..., dict]
    reference: Callable | None = None
    streamed_operand: int = 0
    fused: bool = False
    operands: Callable[..., tuple] | None = None
    composition: Callable | None = None


OPS: dict[str, OpDescriptor] = {}


def register_op(desc: OpDescriptor) -> OpDescriptor:
    OPS[desc.name] = desc
    return desc


def wrapper_for(name: str):
    """Public name -> policy-dispatched wrapper."""
    return OPS[name].wrapper


def kernel_shapes(name: str, *operands) -> dict:
    """The pipeline-layer shape dict for a kernel's operands, in the
    public wrapper's operand order."""
    return OPS[name].shapes(*operands)


def tuned_call(name: str, *operands, **kwargs):
    """Run a kernel under the active KernelPolicy: reference short-circuit,
    a pinned plan (dict override), or the tuned plan, raced on a miss —
    see `KernelPolicy.call`."""
    return current_policy().call(name, *operands, **kwargs)


def _shapes_mn(*xs):
    x = xs[-1]
    return {"m": x.shape[0], "n": x.shape[1]}


def _shapes_matmul(a, b, *_):
    return {"m": a.shape[0], "k": a.shape[1], "n": b.shape[1]}


def _shapes_conv2d(x, w):
    return {"h": x.shape[0], "w": x.shape[1]}


def _shapes_dct8x8(blocks):
    return {"n": blocks.shape[0]}


def _shapes_rmsnorm(x, scale):
    return {"m": x.shape[0], "d": x.shape[1]}


def _shapes_flash_attention(q, k, v):
    b, h, s, hd = q.shape
    return {"b": b, "h": h, "kv": k.shape[1], "s": s, "hd": hd}


def _shapes_rmsnorm_matmul(x, scale, w):
    return {"m": x.shape[0], "k": x.shape[1], "n": w.shape[1]}


def _shapes_flash_attention_proj(q, k, v, wo):
    b, h, s, hd = q.shape
    return {"b": b, "h": h, "kv": k.shape[1], "s": s, "hd": hd,
            "dm": wo.shape[-1]}


# -- operand factories (seeded; one seed per operand, as the reference) -----

def _rand(seed: int, shape: tuple, dtype, device, scale: float = 1.0):
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _mk_axpy(s, dt, device=None):
    return (2.0, _rand(0, (s["m"], s["n"]), dt, device),
            _rand(1, (s["m"], s["n"]), dt, device))


def _mk_dotp(s, dt, device=None):
    return (_rand(2, (s["m"], s["n"]), dt, device),
            _rand(3, (s["m"], s["n"]), dt, device))


def _mk_matmul(s, dt, device=None):
    return (_rand(4, (s["m"], s["k"]), dt, device),
            _rand(5, (s["k"], s["n"]), dt, device))


def _mk_conv2d(s, dt, device=None):
    return (_rand(6, (s["h"], s["w"]), dt, device),
            _rand(7, (3, 3), dt, device))


def _mk_dct8x8(s, dt, device=None):
    return (_rand(8, (s["n"], 8, 8), dt, device),)


def _mk_rmsnorm(s, dt, device=None):
    return (_rand(9, (s["m"], s["d"]), dt, device),
            _rand(10, (s["d"],), dt, device, 0.1))


def _mk_flash_attention(s, dt, device=None):
    b, h, kv, sq, hd = (s[k] for k in ("b", "h", "kv", "s", "hd"))
    return (_rand(11, (b, h, sq, hd), dt, device),
            _rand(12, (b, kv, sq, hd), dt, device),
            _rand(13, (b, kv, sq, hd), dt, device))


def _mk_rmsnorm_matmul(s, dt, device=None):
    return (_rand(14, (s["m"], s["k"]), dt, device),
            _rand(15, (s["k"],), dt, device, 0.1),
            _rand(16, (s["k"], s["n"]), dt, device))


def _mk_matmul_bias_act(s, dt, device=None):
    return (_rand(17, (s["m"], s["k"]), dt, device),
            _rand(18, (s["k"], s["n"]), dt, device),
            _rand(19, (s["n"],), dt, device))


def _mk_matmul_residual_add(s, dt, device=None):
    return (_rand(20, (s["m"], s["k"]), dt, device),
            _rand(21, (s["k"], s["n"]), dt, device),
            _rand(22, (s["m"], s["n"]), dt, device))


def _mk_flash_attention_proj(s, dt, device=None):
    b, h, kv, sq, hd, dm = (s[k] for k in ("b", "h", "kv", "s", "hd", "dm"))
    return (_rand(23, (b, h, sq, hd), dt, device),
            _rand(24, (b, kv, sq, hd), dt, device),
            _rand(25, (b, kv, sq, hd), dt, device),
            _rand(26, (h, hd, dm), dt, device, 0.1))


# -- unfused compositions (the fused kernels' race opponents) ----------------
# The reference's `_comp_*`: the primitive wrappers above under the active
# policy, with the epilogue written in PyTorch.

def _comp_rmsnorm_matmul(x, scale, w):
    return matmul(rmsnorm(x, scale), w)


def _comp_matmul_bias_act(a, b, bias, *, act: str = "gelu"):
    h = matmul(a, b).to(F32) + bias.to(F32)
    return _ref.ACTIVATIONS[act](h).to(a.dtype)


def _comp_matmul_residual_add(a, b, res):
    return (matmul(a, b).to(F32) + res.to(F32)).to(a.dtype)


def _comp_flash_attention_proj(q, k, v, wo, *, causal: bool = True):
    o = flash_attention(q, k, v, causal=causal)
    return torch.einsum("bhsk,hkd->bsd", o.to(F32),
                        wo.to(F32)).to(q.dtype)


for _desc in (
    OpDescriptor("axpy", axpy, _shapes_mn, _ref.axpy, streamed_operand=1,
                 operands=_mk_axpy),
    OpDescriptor("dotp", dotp, _shapes_mn, _ref.dotp, operands=_mk_dotp),
    OpDescriptor("matmul", matmul, _shapes_matmul, _ref.matmul,
                 operands=_mk_matmul),
    OpDescriptor("conv2d", conv2d_3x3, _shapes_conv2d, _ref.conv2d_3x3,
                 operands=_mk_conv2d),
    OpDescriptor("dct8x8", dct8x8, _shapes_dct8x8, _ref.dct8x8,
                 operands=_mk_dct8x8),
    OpDescriptor("rmsnorm", rmsnorm, _shapes_rmsnorm, _ref.rmsnorm,
                 operands=_mk_rmsnorm),
    OpDescriptor("flash_attention", flash_attention,
                 _shapes_flash_attention, _ref_flash_attention,
                 operands=_mk_flash_attention),
    OpDescriptor("rmsnorm_matmul", rmsnorm_matmul, _shapes_rmsnorm_matmul,
                 _ref.rmsnorm_matmul, fused=True,
                 operands=_mk_rmsnorm_matmul,
                 composition=_comp_rmsnorm_matmul),
    OpDescriptor("matmul_bias_act", matmul_bias_act, _shapes_matmul,
                 _ref.matmul_bias_act, fused=True,
                 operands=_mk_matmul_bias_act,
                 composition=_comp_matmul_bias_act),
    OpDescriptor("matmul_residual_add", matmul_residual_add, _shapes_matmul,
                 _ref.matmul_residual_add, fused=True,
                 operands=_mk_matmul_residual_add,
                 composition=_comp_matmul_residual_add),
    OpDescriptor("flash_attention_proj", flash_attention_proj,
                 _shapes_flash_attention_proj, _ref.flash_attention_proj,
                 fused=True, operands=_mk_flash_attention_proj,
                 composition=_comp_flash_attention_proj),
):
    register_op(_desc)

"""Policy-dispatched kernel ops — the port's `repro.kernels.ops`: the
paper's Table 1 suite (`matmul`, `axpy`, `dotp`, `conv2d_3x3`, `dct8x8`),
`rmsnorm` and `flash_attention`, and the four fused kernels, each with
the reference's custom VJP as a `torch.autograd.Function`.

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

Gradients. The "reference" mode is plain autograd through the oracles,
as the reference's is. On the kernel and plain routes a fused op whose
input requires grad runs through its `torch.autograd.Function`
(`RmsnormMatmulFn`, `MatmulBiasActFn`, `MatmulResidualAddFn`,
`FlashAttentionProjFn`): the forward is the route's (the Hopper kernel on
the card, the plain version on the CPU), the inputs are the residuals,
and the backward is the VJP of the reference's composition (`_ref_*` of
the reference's `ops.py`) recomputed from them, as the reference's
`custom_vjp` is; the composition's last product, dead in the VJP, is not
rerun. The VJPs take their products through `models.layers.product`
(bf16 on the tensor cores on the card). Where the tuning race picked a
fused op's unfused composition, the composition is the forward of the
same Function under grad. No TPU kernel has a backward kernel, so
neither has the port. `flash_attention` has no VJP in the reference
(`jax.grad` through its Pallas call fails): on those routes it raises
under grad. A kernel wrapper given an operand that requires grad
outside these Functions raises (`build.check_operands`): a launch
carries no gradient.
"""

from __future__ import annotations

import dataclasses
import functools
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
    q: (B, H, S, hd); k/v: (B, KV, S, hd). Forward only outside the
    "reference" mode, as in the reference."""
    route = _route("flash_attention")
    if route == "reference":
        return _ref_flash_attention(q, k, v, causal=causal)
    if _needs_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention has no VJP: the reference's Pallas call has "
            "none either (jax.grad through it fails). Train through the "
            "fused route (flash_attention_proj) or the chunked schedules' "
            "flash VJP (models/attention.py)")
    _check_blocks(bq=(q.shape[2], bq), bk=(q.shape[2], bk))
    if route == "plain":
        return _fa.flash_attention_plain(q, k, v, causal)
    return _fa.flash_attention(q, k, v, causal)


# ----------------------------------------------------------------------------
# The fused kernels: the route's forward, the reference composition's VJP
# ----------------------------------------------------------------------------

def _needs_grad(*tensors) -> bool:
    """Will autograd record an op on these inputs?"""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class _FusedVJP(torch.autograd.Function):
    """`run(*inputs)` forward (the route's: the Hopper kernel on the card,
    the plain version on the CPU, or the race's unfused composition) with
    the inputs saved as residuals; the backward is `vjp(grad, need,
    *inputs)`, the VJP of the reference's composition recomputed from
    them (the reference's `_*_fwd` / `_*_bwd` pair)."""

    @staticmethod
    def forward(ctx, run, vjp, *inputs):
        ctx.vjp = vjp
        ctx.save_for_backward(*inputs)
        return run(*inputs)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *ctx.vjp(grad, ctx.needs_input_grad[2:],
                                     *ctx.saved_tensors))


class RmsnormMatmulFn(_FusedVJP):
    """rmsnorm_matmul's VJP (reference `ops.py:241-261`)."""


class MatmulBiasActFn(_FusedVJP):
    """matmul_bias_act's VJP (reference `ops.py:278-299`)."""


class MatmulResidualAddFn(_FusedVJP):
    """matmul_residual_add's VJP (reference `ops.py:318-339`)."""


class FlashAttentionProjFn(_FusedVJP):
    """flash_attention_proj's VJP (reference `ops.py:357-383`)."""


def _fused_call(fn_cls, run, vjp, *inputs):
    """`run(*inputs)`, through `fn_cls` when autograd records it."""
    if _needs_grad(*inputs):
        return fn_cls.apply(run, vjp, *inputs)
    return run(*inputs)


# The VJPs of the reference's `_ref_*` compositions: every product through
# `models.layers.product` (f32 accumulation; bf16 on the tensor cores on
# the card), rounded where the reference rounds. A composition's last
# product is not rerun where its value is dead in the VJP: its two
# transposed products are written out, and autograd takes the part of the
# composition before it (the rmsnorm, the attention). matmul_bias_act's
# activation reads its product's value, so it is recomputed.

def _leaves(xs, need):
    """Detached copies of `xs`, each requiring grad where `need` says."""
    return [x.detach().requires_grad_(n) for x, n in zip(xs, need)]


def _grads(out, xs, need, cot):
    """The VJP of `out` (recorded from `xs`) at `cot`, None where not
    needed."""
    if not any(need):
        return [None] * len(xs)
    got = iter(torch.autograd.grad(
        out, [x for x, n in zip(xs, need) if n], cot))
    return [next(got) if n else None for n in need]


def _vjp_rmsnorm_matmul(g, need, x, scale, w):
    """out = product(rmsnorm(x, scale), w), rounded to x's dtype."""
    from repro_torch.models.layers import product
    with torch.enable_grad():
        xs = _leaves((x, scale), need[:2])
        xn = _ref.rmsnorm(*xs)
    dw = product("mk,mn->kn", xn.detach(), g, w.dtype) if need[2] else None
    dxn = product("mn,kn->mk", g, w, xn.dtype) if any(need[:2]) else None
    return (*_grads(xn, xs, need[:2], dxn), dw)


def _vjp_matmul_bias_act(act, g, need, a, b, bias):
    """out = act(product(a, b, f32) + bias), rounded to a's dtype."""
    from repro_torch.models.layers import product

    def composition(a, b, bias):
        h = product("mk,kn->mn", a, b, F32) + bias.to(F32)
        return _ref.ACTIVATIONS[act](h).to(a.dtype)

    with torch.enable_grad():
        xs = _leaves((a, b, bias), need)
        out = composition(*xs)
    return _grads(out, xs, need, g)


def _vjp_matmul_residual_add(g, need, a, b, res):
    """out = (product(a, b, f32) + res), rounded to a's dtype: the f32
    cotangent rounded to the operands' dtype for both products, as
    `layers.F32Product` rounds it."""
    from repro_torch.models.layers import product
    g32 = g.to(F32)
    ga = g32.to(a.dtype)
    return (product("mn,kn->mk", ga, b, a.dtype) if need[0] else None,
            product("mk,mn->kn", a, ga, b.dtype) if need[1] else None,
            g32.to(res.dtype) if need[2] else None)


def _attention(causal, q, k, v):
    """The reference composition's attention (GQA repeated, f32 scores,
    the probabilities rounded to v's dtype for p @ v)."""
    from repro_torch.models.layers import product
    g = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s, hd = q.shape[2], q.shape[3]
    scores = product("bhqd,bhkd->bhqk", q, kr, F32) * hd ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, _ref.NEG)
    p = torch.softmax(scores, dim=-1)
    return product("bhqk,bhkd->bhqd", p.to(v.dtype), vr, v.dtype)


def _vjp_flash_attention_proj(causal, g, need, q, k, v, wo):
    """out = product(attention(q, k, v), wo), rounded to q's dtype."""
    from repro_torch.models.layers import product
    with torch.enable_grad():
        xs = _leaves((q, k, v), need[:3])
        o = _attention(causal, *xs)
    dwo = (product("bhsk,bsd->hkd", o.detach(), g, wo.dtype) if need[3]
           else None)
    do = product("bsd,hkd->bhsk", g, wo, o.dtype) if any(need[:3]) else None
    return (*_grads(o, xs, need[:3], do), dwo)


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
        run = _fused.rmsnorm_matmul_plain
    else:
        run = functools.partial(_fused.rmsnorm_matmul, tile_n=tile_n,
                                boxes=boxes, cluster=cluster)
    return _fused_call(RmsnormMatmulFn, run, _vjp_rmsnorm_matmul,
                       x, scale, w)


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
        run = functools.partial(_fused.matmul_bias_act_plain, act=act)
    else:
        run = functools.partial(_fused.matmul_bias_act, act=act,
                                tile_n=tile_n, boxes=boxes, cluster=cluster)
    return _fused_call(MatmulBiasActFn, run,
                       functools.partial(_vjp_matmul_bias_act, act),
                       a, b, bias)


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
        run = _fused.matmul_residual_add_plain
    else:
        run = functools.partial(_fused.matmul_residual_add, tile_n=tile_n,
                                boxes=boxes, cluster=cluster)
    return _fused_call(MatmulResidualAddFn, run, _vjp_matmul_residual_add,
                       a, b, res)


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
        run = functools.partial(_fused.flash_attention_proj_plain,
                                causal=causal)
    else:
        run = functools.partial(_fused.flash_attention_proj, causal=causal,
                                tile_n=tile_n)
    return _fused_call(FlashAttentionProjFn, run,
                       functools.partial(_vjp_flash_attention_proj, causal),
                       q, k, v, wo)


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
# policy, with the epilogue written in PyTorch. Under grad a composition
# runs as the forward of its fused op's Function, whose backward is the
# fused op's VJP: the primitive launches carry no gradient.

def _comp_rmsnorm_matmul(x, scale, w):
    return _fused_call(RmsnormMatmulFn,
                       lambda x, scale, w: matmul(rmsnorm(x, scale), w),
                       _vjp_rmsnorm_matmul, x, scale, w)


def _comp_matmul_bias_act(a, b, bias, *, act: str = "gelu"):
    def run(a, b, bias):
        h = matmul(a, b).to(F32) + bias.to(F32)
        return _ref.ACTIVATIONS[act](h).to(a.dtype)

    return _fused_call(MatmulBiasActFn, run,
                       functools.partial(_vjp_matmul_bias_act, act),
                       a, b, bias)


def _comp_matmul_residual_add(a, b, res):
    def run(a, b, res):
        return (matmul(a, b).to(F32) + res.to(F32)).to(a.dtype)

    return _fused_call(MatmulResidualAddFn, run, _vjp_matmul_residual_add,
                       a, b, res)


def _comp_flash_attention_proj(q, k, v, wo, *, causal: bool = True):
    def run(q, k, v, wo):
        o = flash_attention(q, k, v, causal=causal)
        return torch.einsum("bhsk,hkd->bsd", o.to(F32),
                            wo.to(F32)).to(q.dtype)

    return _fused_call(FlashAttentionProjFn, run,
                       functools.partial(_vjp_flash_attention_proj, causal),
                       q, k, v, wo)


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

"""Parameter specs and core layers (the port of `repro.models.layers`).

Numerics follow the reference: bf16 parameters and activations, f32
inside norms, softmax and rotary embeddings, f32 accumulation in every
product with the result rounded back to the activation dtype (`product`:
bf16 tensor-core products on the card, f32 products elsewhere).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import remat
from repro_torch.device import on_card
from repro_torch.kernels.ref import ACTIVATIONS

F32 = torch.float32
Logical = tuple

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: Logical
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"      # normal | zeros | ones | embed
    scale: float | None = None  # None -> 1/sqrt(fan_in)

    def materialize(self, generator: torch.Generator,
                    device) -> torch.Tensor:
        """Draw this parameter on `device` from `generator` (which must
        live on the same device). Normal draws are made in f32 and rounded
        to the parameter dtype, as the reference does."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        scale = self.scale if self.scale is not None else fan_in ** -0.5
        if self.init == "embed":
            scale = 1.0
        x = torch.randn(self.shape, generator=generator, dtype=F32,
                        device=device)
        return (x.mul_(scale)).to(self.dtype)


# ----------------------------------------------------------------------------
# Normalization / activations
# ----------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    """In f32 (float64 for a float64 x), rounded to x's dtype."""
    dt = x.dtype
    acc = wide(dt)
    xf = x.to(acc)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(acc))).to(dt)


def wide(*dtypes) -> torch.dtype:
    """The dtype f32 work on these dtypes takes: f32, or float64 where
    one of them is float64 (xlstm's mLSTM heads in an f32 run)."""
    out = F32
    for dt in dtypes:
        out = torch.promote_types(out, dt)
    return out


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """(x - mean) * rsqrt(var + eps) * scale + bias in f32, the population
    variance, rounded to x's dtype (the scale is `scale`, not 1 + scale)."""
    dt = x.dtype
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(dt)


# ----------------------------------------------------------------------------
# Products outside any kernel (the reference's einsums)
# ----------------------------------------------------------------------------

def product(eq: str, a, b, out_dtype) -> torch.Tensor:
    """`einsum(eq, a, b)` with f32 accumulation and one rounding, to
    `out_dtype`: the reference's einsum on bf16 operands (f32 out where it
    asks for `preferred_element_type=F32`, the operand dtype elsewhere).

    On the card's route (`device.on_card`: CUDA, or meta in a dry run's
    trace), bf16 operands run on the tensor cores as one `mm` / `bmm`:
    cuBLAS accumulates in f32 and rounds once to a bf16 output, or writes
    an f32 output (`out_dtype=`) when f32 is asked for. PyTorch's
    `allow_bf16_reduced_precision_reduction` is left as the caller has it
    (True by default: a split-K kernel may then add partial sums in bf16;
    `tools/plain_products.py` checks the paths' shapes for that).
    Elsewhere both operands are upcast and multiplied in f32 (the same
    function: a product of bf16 values is exact in f32). Under grad the f32
    result's product is `F32Product`; every other path is plain
    autograd. Its `mm` / `bmm` runs marked as a product with or without
    a batch index (`core.remat`: what cfg.remat "dots" and
    "dots_no_batch" keep)."""
    with remat.marked(remat.product_kind(eq, a.ndim, b.ndim)):
        if on_card(a) and a.dtype == b.dtype == torch.bfloat16:
            return _tensor_core_product(eq, a, b, out_dtype).to(out_dtype)
        acc = wide(a.dtype, b.dtype)
        return torch.einsum(eq, a.to(acc), b.to(acc)).to(out_dtype)


def _tensor_core_product(eq: str, a, b, out_dtype) -> torch.Tensor:
    """Two-operand einsum lowered to one `mm` / `bmm` with a bf16 result
    (an f32 one for any other `out_dtype`): the indices of all three terms
    are the batch, those of a or of b alone with the output the rows or
    the columns, those of both operands alone the contraction."""
    ins, out = eq.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    if "..." in ia:
        extra = "".join(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                        if c not in eq)[:a.ndim - len(ia) + 3]
        ia, out = ia.replace("...", extra), out.replace("...", extra)
    size = dict(zip(ia, a.shape)) | dict(zip(ib, b.shape))
    batch = [c for c in out if c in ia and c in ib]
    rows = [c for c in out if c in ia and c not in ib]
    cols = [c for c in out if c in ib and c not in ia]
    red = [c for c in ia if c in ib and c not in out]
    if sorted(batch + rows + red) != sorted(ia) or \
            sorted(batch + cols + red) != sorted(ib):
        raise ValueError(f"product: {eq!r} sums an index of one operand")

    def n(idx):
        k = 1
        for c in idx:
            k *= size[c]
        return k

    am = a.permute([ia.index(c) for c in batch + rows + red]).reshape(
        n(batch), n(rows), n(red))
    bm = b.permute([ib.index(c) for c in batch + red + cols]).reshape(
        n(batch), n(red), n(cols))
    if not batch:
        am, bm = am[0], bm[0]
    if out_dtype == torch.bfloat16:
        y = torch.bmm(am, bm) if batch else torch.mm(am, bm)
    elif torch.is_grad_enabled() and (am.requires_grad or bm.requires_grad):
        y = F32Product.apply(am, bm)
    else:
        y = _mm_f32(am, bm)
    order = batch + rows + cols
    y = y.reshape([size[c] for c in order])
    return y.permute([order.index(c) for c in out])


def _mm_f32(a, b):
    """`mm` / `bmm` of bf16 operands with an f32 result (cuBLAS, f32
    accumulation, no rounding)."""
    return (torch.bmm if a.ndim == 3 else torch.mm)(a, b, out_dtype=F32)


class F32Product(torch.autograd.Function):
    """`_mm_f32` with its VJP written out (the out_dtype overloads' own
    derivative is not relied on): the f32 cotangent is rounded to the
    operands' dtype and both transposed products run on the tensor cores,
    f32 accumulation, each gradient rounded to its operand's dtype as the
    reference rounds it. The reference transposes an f32 cotangent
    without that first rounding; its relative size, 2^-9 an element, is
    that of the gradient's own rounding."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        mm = torch.bmm if a.ndim == 3 else torch.mm
        da = mm(g, b.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        db = mm(a.transpose(-1, -2), g) if ctx.needs_input_grad[1] else None
        return da, db


def _mm(x, w, eq: str):
    """einsum with f32 accumulation, rounded back to x's dtype."""
    return product(eq, x, w, x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = _mm(x, w_gate, "...d,df->...f")
    u = _mm(x, w_up, "...d,df->...f")
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return _mm(h, w_down, "...f,fd->...d")


def geglu(x, w_gate, w_up, w_down):
    """recurrentgemma's MLP: swiglu with gelu (the tanh form) in place of
    silu."""
    g = _mm(x, w_gate, "...d,df->...f")
    u = _mm(x, w_up, "...d,df->...f")
    h = ACTIVATIONS["gelu"](g.to(F32)).to(x.dtype) * u
    return _mm(h, w_down, "...f,fd->...d")


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """Whisper's MLP: b_in is added in x's dtype to the rounded product,
    then gelu (the tanh form, jax.nn.gelu's default) in f32."""
    h = _mm(x, w_in, "...d,df->...f") + b_in
    h = ACTIVATIONS["gelu"](h.to(F32)).to(x.dtype)
    return _mm(h, w_out, "...f,fd->...d") + b_out


# ----------------------------------------------------------------------------
# Rotary position embeddings (two halves rotated, not interleaved pairs)
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=F32, device=device) \
        / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].to(F32) * freqs        # (..., seq, hd/2)
    angles = angles[..., None, :]                         # broadcast heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Shared spec builders
# ----------------------------------------------------------------------------

def attn_specs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
               *, qkv_bias: bool = False, qk_norm: bool = False,
               dtype=torch.bfloat16) -> dict:
    s = {
        "wq": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", None), dtype),
        "wk": ParamSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", None), dtype),
        "wv": ParamSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", None), dtype),
        "wo": ParamSpec((n_heads, head_dim, d_model), ("heads", None, "embed"), dtype),
    }
    if qkv_bias:
        s |= {
            "bq": ParamSpec((n_heads, head_dim), ("heads", None), dtype, init="zeros"),
            "bk": ParamSpec((n_kv_heads, head_dim), ("kv_heads", None), dtype, init="zeros"),
            "bv": ParamSpec((n_kv_heads, head_dim), ("kv_heads", None), dtype, init="zeros"),
        }
    if qk_norm:
        s |= {
            "q_norm": ParamSpec((head_dim,), ("norm",), dtype, init="zeros"),
            "k_norm": ParamSpec((head_dim,), ("norm",), dtype, init="zeros"),
        }
    return s


def ffn_specs(d_model: int, d_ff: int, *, kind: str = "swiglu",
              dtype=torch.bfloat16) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d_model, d_ff), ("embed", "ffn"), dtype),
            "w_up": ParamSpec((d_model, d_ff), ("embed", "ffn"), dtype),
            "w_down": ParamSpec((d_ff, d_model), ("ffn", "embed"), dtype),
        }
    if kind == "gelu":  # whisper-style MLP with biases
        return {
            "w_in": ParamSpec((d_model, d_ff), ("embed", "ffn"), dtype),
            "b_in": ParamSpec((d_ff,), ("ffn",), dtype, init="zeros"),
            "w_out": ParamSpec((d_ff, d_model), ("ffn", "embed"), dtype),
            "b_out": ParamSpec((d_model,), ("embed",), dtype, init="zeros"),
        }
    raise ValueError(kind)


def apply_ffn(params: dict, x, *, kind: str = "swiglu"):
    if kind == "swiglu":
        return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    if kind == "geglu":
        return geglu(x, params["w_gate"], params["w_up"], params["w_down"])
    if kind == "gelu":
        return gelu_mlp(x, params["w_in"], params["b_in"], params["w_out"],
                        params["b_out"])
    raise ValueError(kind)


def qkv_postprocess(params: dict, q, k, v, positions, *, qkv_bias=False,
                    qk_norm=False, rope=True, theta=1e4):
    """Bias / qk-norm / rope tail shared by the plain and fused qkv paths."""
    if qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def qkv_project(params: dict, x, positions, *, n_heads, n_kv_heads, head_dim,
                qkv_bias=False, qk_norm=False, rope=True, theta=1e4):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd) with rope applied."""
    q = _mm(x, params["wq"], "bsd,dhk->bshk")
    k = _mm(x, params["wk"], "bsd,dhk->bshk")
    v = _mm(x, params["wv"], "bsd,dhk->bshk")
    return qkv_postprocess(params, q, k, v, positions, qkv_bias=qkv_bias,
                           qk_norm=qk_norm, rope=rope, theta=theta)


def out_project(params: dict, attn_out):
    """attn_out: (B, S, H, hd) -> (B, S, d)."""
    return _mm(attn_out, params["wo"], "bshk,hkd->bsd")


# ----------------------------------------------------------------------------
# Fused kernel routing (KernelPolicy mode "fused")
# ----------------------------------------------------------------------------
#
# These helpers flatten the leading dims, hand the kernels dense operands
# (a transposed or sliced view is copied first: the kernels take no
# strides) and dispatch through kernels/ops.py.

def dense(t: torch.Tensor) -> torch.Tensor:
    """`t` itself if it is contiguous and 32-byte aligned, else a copy."""
    if t.is_contiguous() and t.data_ptr() % 32 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def fused_norm_matmul(x, scale, w):
    """rmsnorm(x, scale) @ w in one fused call (`ops.rmsnorm_matmul`).
    x: (..., d); scale: (d,); w: (d, f) -> (..., f)."""
    from repro_torch.kernels import ops
    d = x.shape[-1]
    y = ops.rmsnorm_matmul(dense(x.reshape(-1, d)), dense(scale), dense(w))
    return y.reshape(*x.shape[:-1], w.shape[1])


def fused_matmul_residual(h, w, res):
    """h @ w + res with the residual added in the output epilogue.
    h: (..., f); w: (f, d); res: (..., d) -> (..., d)."""
    from repro_torch.kernels import ops
    f = h.shape[-1]
    y = ops.matmul_residual_add(dense(h.reshape(-1, f)), dense(w),
                                dense(res.reshape(-1, w.shape[1])))
    return y.reshape(res.shape)


def fused_matmul_bias_act(h, w, bias, act: str):
    """act(h @ w + bias) with the bias and activation in the output
    epilogue. h: (..., f); w: (f, d); bias: (d,) -> (..., d)."""
    from repro_torch.kernels import ops
    f = h.shape[-1]
    y = ops.matmul_bias_act(dense(h.reshape(-1, f)), dense(w), dense(bias),
                            act=act)
    return y.reshape(*h.shape[:-1], w.shape[1])


def fused_attention_proj(q, k, v, wo, *, causal: bool = True):
    """Flash attention + output projection in one kernel.
    q: (B, S, H, hd), k/v: (B, S, KV, hd) (model layout), wo: (H, hd, d)
    -> (B, S, d). The transposes to the kernel layout are made dense."""
    from repro_torch.kernels import ops
    qt = dense(q.transpose(1, 2))
    kt = dense(k.transpose(1, 2))
    vt = dense(v.transpose(1, 2))
    return ops.flash_attention_proj(qt, kt, vt, dense(wo), causal=causal)

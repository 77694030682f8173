"""Plain PyTorch oracles — the counterparts of `repro.kernels.ref` and of
the `_ref_*` compositions in `repro.kernels.ops` that the ``"reference"``
policy mode routes to. The Table 1 suite's oracles (matmul, axpy, dotp,
conv2d_3x3, dct8x8) are the reference's own, line for line.

These follow the reference package's *oracles*, not its kernels: the
residual add and the bias-activation epilogue round once (the kernels
round twice, see `fused.py`), and attention is a full-softmax
composition.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
NEG = -1e30

# the reference's `kernels/fused.py` ACTIVATIONS: its "gelu" is
# `jax.nn.gelu`, whose default is the tanh approximation (torch's default
# is the exact erf form)
ACTIVATIONS = {
    "none": lambda x: x,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


def matmul(a, b):
    return (a.to(F32) @ b.to(F32)).to(a.dtype)


def tf32_rna(x):
    """x (f32) rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as `cvt.rna.tf32.f32` does: half of the 13 dropped
    bits' weight is added to the magnitude (sign-magnitude bits), then
    they are cleared."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def tf32_split(x):
    """(hi, lo) of x (f32) as the f32 matmul kernel splits it (`split` in
    csrc/tf32x3_gemm.cuh): hi = tf32(x), lo = tf32(x - hi); a finite x
    that rounds past FLT_MAX takes hi = x truncated to TF32; a non-finite
    x is hi = +-1 (x's sign), lo = x."""
    x = x.to(F32).contiguous()
    finite = torch.isfinite(x)
    hi = tf32_rna(x)
    hi = torch.where(finite & ~torch.isfinite(hi),
                     (x.view(torch.int32) & ~0x1FFF).view(F32), hi)
    hi = torch.where(finite, hi, torch.copysign(torch.ones_like(x), x))
    lo = torch.where(finite, tf32_rna(x - hi), x)
    return hi, lo


def matmul_tf32x3(a, b, passes: int = 3):
    """a @ b as the f32 matmul kernel computes it (csrc/tf32x3_gemm.cuh),
    for tests: each operand split into hi and lo (`tf32_split`), and the
    three products lo_a.hi_b, hi_a.lo_b and hi_a.hi_b (exact in f32)
    summed in f32. `passes=1` keeps hi_a.hi_b alone (one TF32 product),
    which loses what the split is for. The plain version stays
    `matmul`."""
    (a_hi, a_lo), (b_hi, b_lo) = tf32_split(a), tf32_split(b)
    if passes == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def axpy(alpha, x, y):
    """alpha: a Python number or a tensor holding one value."""
    a = torch.as_tensor(alpha, dtype=F32, device=x.device)
    return (a * x.to(F32) + y.to(F32)).to(x.dtype)


def dotp(x, y):
    """A 0-d f32 tensor, whatever the operands' dtype."""
    return torch.sum(x.to(F32) * y.to(F32))


def conv2d_3x3(x, w):
    """x: (H, W); w: (3, 3). Zero-padded 'same' convolution (correlation),
    the nine products summed dy outer, dx inner, from 0."""
    h, wd = x.shape
    xp = torch.nn.functional.pad(x.to(F32), (1, 1, 1, 1))
    wf = w.to(F32)
    out = torch.zeros((h, wd), dtype=F32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            out = out + wf[dy, dx] * xp[dy:dy + h, dx:dx + wd]
    return out.to(x.dtype)


def dct_matrix(n: int = 8) -> np.ndarray:
    """The orthonormal DCT-II matrix, as float32 numpy (the reference's
    `repro.kernels.ref.dct_matrix`, kept here because that module imports
    jax)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    c = np.sqrt(2.0 / n) * np.cos((2 * i + 1) * k * np.pi / (2 * n))
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


def dct8x8(blocks):
    """blocks: (N, 8, 8) -> 2-D DCT per block: C X C^T."""
    c = torch.from_numpy(dct_matrix(8)).to(blocks.device)
    return torch.einsum("ij,njk,lk->nil", c, blocks.to(F32),
                        c).to(blocks.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(F32))).to(x.dtype)


def flash_attention(q, k, v, *, causal: bool = True):
    """q, k, v: (B, H, S, hd) (GQA already resolved by the caller)."""
    s, hd = q.shape[2], q.shape[3]
    scores = (q.to(F32) @ k.to(F32).transpose(-1, -2)) * hd ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, NEG))
    p = torch.softmax(scores, dim=-1)
    return (p.to(v.dtype).to(F32) @ v.to(F32)).to(v.dtype)


def rmsnorm_matmul(x, scale, w):
    return (rmsnorm(x, scale).to(F32) @ w.to(F32)).to(x.dtype)


def matmul_bias_act(a, b, bias, act: str = "gelu"):
    """act(a @ b + bias) in f32, rounded once (`ops._ref_matmul_bias_act`)."""
    h = a.to(F32) @ b.to(F32) + bias.to(F32)
    return ACTIVATIONS[act](h).to(a.dtype)


def matmul_residual_add(a, b, res):
    return ((a.to(F32) @ b.to(F32)) + res.to(F32)).to(a.dtype)


def flash_attention_proj(q, k, v, wo, *, causal: bool = True):
    g = q.shape[1] // k.shape[1]
    o = flash_attention(q, k.repeat_interleave(g, dim=1),
                        v.repeat_interleave(g, dim=1), causal=causal)
    return torch.einsum("bhsk,hkd->bsd", o.to(F32),
                        wo.to(F32)).to(q.dtype)

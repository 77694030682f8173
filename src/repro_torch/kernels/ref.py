"""Plain PyTorch oracles — the counterparts of `repro.kernels.ref` and of
the `_ref_*` compositions in `repro.kernels.ops` that the ``"reference"``
policy mode routes to.

These follow the reference package's *oracles*, not its kernels: the
residual add rounds once (the kernel rounds twice, see `fused.py`), and
attention is a full-softmax composition.
"""

from __future__ import annotations

import torch

F32 = torch.float32
NEG = -1e30


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


def matmul_residual_add(a, b, res):
    return ((a.to(F32) @ b.to(F32)) + res.to(F32)).to(a.dtype)


def flash_attention_proj(q, k, v, wo, *, causal: bool = True):
    g = q.shape[1] // k.shape[1]
    o = flash_attention(q, k.repeat_interleave(g, dim=1),
                        v.repeat_interleave(g, dim=1), causal=causal)
    return torch.einsum("bhsk,hkd->bsd", o.to(F32),
                        wo.to(F32)).to(q.dtype)

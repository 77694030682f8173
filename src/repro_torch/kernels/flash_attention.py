"""flash_attention — online-softmax attention, causal or full, with GQA:
wrapper, plain version, launch count. Replaces
`repro/kernels/flash_attention.py` _fa_kernel / flash_attention; the kernel
is `csrc/flash_attention.cu` (bound and design in its notes).

The wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernel, or raises (see `fused.py` for the counting convention). The CUDA
kernel takes bf16 with head sizes 64 and 128.
"""

from __future__ import annotations

import torch

from repro_torch.device import on_card

from . import build, pipeline, traced

F32 = torch.float32
NEG = -1e30
HEAD_DIMS = (64, 128)                # the CUDA kernel's compiled head sizes


def attention_f32(q, k, v, causal: bool = True):
    """The reference kernel's arithmetic as one softmax over all keys,
    before the output's rounding: f32 scores times hd^-0.5, masked with
    -1e30, p rounded to v.dtype before p@v while l sums the unrounded p;
    returns acc / max(l, 1e-30) in f32. q: (B,H,S,hd); k/v: (B,KV,S,hd),
    head h reading kv head h // (H/KV). Equal to the Pallas kernel where
    its kv block spans the sequence (S <= 512); above, the kernel rescales
    per block, which in bf16 rounds p differently."""
    h, s, hd = q.shape[1], q.shape[2], q.shape[3]
    g = h // k.shape[1]
    kf = k.repeat_interleave(g, dim=1).to(F32)
    vv = v.repeat_interleave(g, dim=1)
    scores = (q.to(F32) @ kf.transpose(-1, -2)) * hd ** -0.5
    if causal:
        ok = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(ok, scores, torch.full_like(scores, NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    return (p.to(vv.dtype).to(F32) @ vv.to(F32)) / torch.clamp(l, min=1e-30)


def flash_attention_plain(q, k, v, causal: bool = True):
    """`attention_f32` rounded once to q.dtype."""
    traced.count_plain(flash_attention_plain, q)
    return attention_f32(q, k, v, causal).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True):
    """q: (B, H, S, hd); k/v: (B, KV, S, hd), H % KV == 0 -> (B, H, S, hd)
    in q.dtype."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    if k.shape != (b, kv, s, hd) or v.shape != k.shape or h % kv:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not on_card(q):
        return flash_attention_plain(q, k, v, causal)
    build.check_operands("flash_attention", q, k, v)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes hd in "
                         f"{HEAD_DIMS}; got hd={hd}")
    out = torch.empty_like(q)
    if b == 0 or h == 0 or s == 0:
        return out
    if q.is_meta:
        traced.record("flash_attention", dict(b=b, h=h, kv=kv, s=s, hd=hd),
                      q.dtype, q.device)
        return out
    err = build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv,
        s, hd, int(bool(causal)), float(hd ** -0.5), build.stream())
    build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


# One-point tune space: the attention core's BQ / BKV / STAGES are
# compile-time (`csrc/attention.cuh`).
def _traffic(s, knobs, db):
    b, h, kv, sq, hd = (s[k] for k in ("b", "h", "kv", "s", "hd"))
    byts = (2.0 * b * h * sq * hd + 2.0 * b * kv * sq * hd) * db
    return pipeline.Traffic(flops=2.0 * b * h * sq * sq * hd, hbm_bytes=byts,
                            ideal_bytes=byts, grid_steps=1, smem_bytes=0,
                            transcendentals=0.5 * b * h * sq * sq)


pipeline.register(pipeline.KernelDef("flash_attention", _traffic,
                                     pipeline.one_point))

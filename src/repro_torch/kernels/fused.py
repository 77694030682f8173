"""The fused producer-consumer kernels of the port: wrappers, plain
versions and launch counts.

Each wrapper takes the reference kernel's operands in the reference
layout. Given CPU tensors it runs its plain PyTorch version (the same
arithmetic, step by step); given CUDA tensors it launches the hand-written
Hopper kernel from `csrc/` on the current stream, or raises — there is no
fallback. Each wrapper counts its launches in ``<wrapper>.launches``; each
plain version counts the calls it served with CUDA tensors in
``<plain>.cuda_calls`` (a run on the card that should go through the
kernels asserts that this stays 0). `launches.py` gathers the counts.

  rmsnorm_matmul       replaces repro/kernels/fused.py build_rmsnorm_matmul
  matmul_bias_act      replaces repro/kernels/fused.py build_matmul_bias_act
  matmul_residual_add  replaces repro/kernels/fused.py
                       build_matmul_residual_add
  flash_attention_proj replaces repro/kernels/fused.py _fa_proj_kernel /
                       flash_attention_proj

Each wrapper's keywords pin its kernel's plan for the tuning layer
(`gemm_plans.py`): ``tile_n`` the mainloop's N tile (flash_attention_proj:
its projection's), ``boxes`` / ``cluster`` the decode kernel's plan at M
<= 16; 0 leaves the kernel its own pick, and a pin the shape's kernel
cannot take raises. The plain versions ignore them. Each registers its
`pipeline.KernelDef` below.

Bounds on an H100 and each design are in the kernel sources' notes.
"""

from __future__ import annotations

import dataclasses

import torch

from . import build, gemm_plans, pipeline, ref
from .flash_attention import attention_f32

F32 = torch.float32
HEAD_DIM = 128                    # flash_attention_proj's compiled head size
ACTS = ("none", "gelu", "silu")   # matmul_bias_act's activation codes, in order


# ----------------------------------------------------------------------------
# rmsnorm_matmul
# ----------------------------------------------------------------------------

def rmsnorm_matmul_plain(x, scale, w, eps: float = 1e-6, **_knobs):
    """bf16-faithful plain version: normalise in f32, round to x.dtype
    (the reference prologue's cast), multiply with f32 accumulation,
    round to x.dtype."""
    if x.is_cuda:
        rmsnorm_matmul_plain.cuda_calls += 1
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(F32))).to(x.dtype)
    return (xn.to(F32) @ w.to(F32)).to(x.dtype)


def rmsnorm_matmul(x, scale, w, eps: float = 1e-6, *, tile_n: int = 0,
                   boxes: int = 0, cluster: int = 0):
    """matmul(rmsnorm(x, scale), w). x: (M, K); scale: (K,); w: (K, N)."""
    m, k = x.shape
    if w.shape[0] != k or scale.shape != (k,):
        raise ValueError(f"rmsnorm_matmul: shapes {tuple(x.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(w.shape)}")
    if not x.is_cuda:
        return rmsnorm_matmul_plain(x, scale, w, eps)
    build.check_operands("rmsnorm_matmul", x, scale, w)
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    ws = build.workspace("rmsnorm_matmul", x.device, m, n, k)
    err = build.entry("rmsnorm_matmul")(
        x.data_ptr(), scale.data_ptr(), w.data_ptr(), out.data_ptr(),
        ws.data_ptr(), m, n, k, float(eps), tile_n, boxes, cluster,
        build.stream())
    build.check("rmsnorm_matmul", err)
    rmsnorm_matmul.launches += 1
    return out


# ----------------------------------------------------------------------------
# matmul_bias_act
# ----------------------------------------------------------------------------

def matmul_bias_act_plain(a, b, bias, act: str = "gelu", **_knobs):
    """The reference *kernel's* double rounding: the matmul result is
    rounded to a.dtype, then the bias is added and the activation applied
    in f32, and the result rounded again (ops._ref_matmul_bias_act rounds
    once)."""
    if a.is_cuda:
        matmul_bias_act_plain.cuda_calls += 1
    y = (a.to(F32) @ b.to(F32)).to(a.dtype)
    return ref.ACTIVATIONS[act](y.to(F32) + bias.to(F32)).to(a.dtype)


def matmul_bias_act(a, b, bias, act: str = "gelu", *, tile_n: int = 0,
                    boxes: int = 0, cluster: int = 0):
    """act(a @ b + bias). a: (M, K); b: (K, N); bias: (N,); act in ACTS."""
    m, k = a.shape
    if act not in ACTS:
        raise ValueError(f"matmul_bias_act: act {act!r} not in {ACTS}")
    if b.shape[0] != k or bias.shape != (b.shape[1],):
        raise ValueError(f"matmul_bias_act: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(bias.shape)}")
    if not a.is_cuda:
        return matmul_bias_act_plain(a, b, bias, act)
    build.check_operands("matmul_bias_act", a, b, bias)
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    ws = build.workspace("matmul_bias_act", a.device, m, n, k)
    err = build.entry("matmul_bias_act")(
        a.data_ptr(), b.data_ptr(), bias.data_ptr(), out.data_ptr(),
        ws.data_ptr(), m, n, k, ACTS.index(act), tile_n, boxes, cluster,
        build.stream())
    build.check("matmul_bias_act", err)
    matmul_bias_act.launches += 1
    return out


# ----------------------------------------------------------------------------
# matmul_residual_add
# ----------------------------------------------------------------------------

def matmul_residual_add_plain(a, b, res, **_knobs):
    """The reference *kernel's* double rounding: the matmul result is
    rounded to a.dtype, then the residual is added in f32 and the sum
    rounded again (ops._ref_matmul_residual_add rounds once)."""
    if a.is_cuda:
        matmul_residual_add_plain.cuda_calls += 1
    y = (a.to(F32) @ b.to(F32)).to(a.dtype)
    return (y.to(F32) + res.to(F32)).to(a.dtype)


def matmul_residual_add(a, b, res, *, tile_n: int = 0, boxes: int = 0,
                        cluster: int = 0):
    """a @ b + res. a: (M, K); b: (K, N); res: (M, N)."""
    m, k = a.shape
    if b.shape[0] != k or res.shape != (m, b.shape[1]):
        raise ValueError(f"matmul_residual_add: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(res.shape)}")
    if not a.is_cuda:
        return matmul_residual_add_plain(a, b, res)
    build.check_operands("matmul_residual_add", a, b, res)
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    ws = build.workspace("matmul_residual_add", a.device, m, n, k)
    err = build.entry("matmul_residual_add")(
        a.data_ptr(), b.data_ptr(), res.data_ptr(), out.data_ptr(),
        ws.data_ptr(), m, n, k, tile_n, boxes, cluster, build.stream())
    build.check("matmul_residual_add", err)
    matmul_residual_add.launches += 1
    return out


# ----------------------------------------------------------------------------
# flash_attention_proj
# ----------------------------------------------------------------------------

def flash_attention_proj_plain(q, k, v, wo, causal: bool = True,
                               **_knobs):
    """Attention with the reference kernel's roundings, then the head-
    summed projection in f32. q: (B,H,S,hd); k/v: (B,KV,S,hd);
    wo: (H,hd,dm) -> (B,S,dm). One softmax over all keys: equal to the
    reference kernel when its kv block spans the sequence (S <= 512)."""
    if q.is_cuda:
        flash_attention_proj_plain.cuda_calls += 1
    o = attention_f32(q, k, v, causal).to(wo.dtype).to(F32)
    return torch.einsum("bhsk,hkd->bsd", o, wo.to(F32)).to(q.dtype)


def flash_attention_proj(q, k, v, wo, causal: bool = True, *,
                         tile_n: int = 0):
    """einsum("bhsk,hkd->bsd", attention(q, k, v), wo) in one call: the
    per-head attention, then the projection over all heads as one GEMM."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    if (k.shape != (b, kv, s, hd) or v.shape != k.shape or h % kv
            or wo.shape[:2] != (h, hd)):
        raise ValueError(f"flash_attention_proj: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(wo.shape)}")
    if not q.is_cuda:
        return flash_attention_proj_plain(q, k, v, wo, causal)
    build.check_operands("flash_attention_proj", q, k, v, wo)
    dm = wo.shape[2]
    if hd != HEAD_DIM or dm % 8:
        raise ValueError(f"flash_attention_proj: the CUDA kernel takes "
                         f"hd={HEAD_DIM} and d_model % 8 == 0; got hd={hd}, "
                         f"d_model={dm}")
    out = torch.empty((b, s, dm), dtype=q.dtype, device=q.device)
    ws = build.workspace("flash_attention_proj", q.device, b, h, s, dm)
    err = build.entry("flash_attention_proj")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), wo.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, h, kv, s, hd, dm,
        int(bool(causal)), tile_n, build.stream())
    build.check("flash_attention_proj", err)
    flash_attention_proj.launches += 1
    return out


# ----------------------------------------------------------------------------
# the tuning layer's view (pipeline.KernelDef)
# ----------------------------------------------------------------------------

def _gemm_def(name: str, extra_bytes, extra_flops) -> pipeline.KernelDef:
    """A fused GEMM op: the product's plans, plus its prologue / epilogue's
    bytes and operations. The kernels take bf16 only, so f32 operands
    have the one point {}. `saved_bytes` is the intermediate's write and
    read the composition would stream."""

    def kind(s, db):
        return None if db == 2 else "fixed"

    def space(s, db):
        return gemm_plans.space(s["m"], s["k"], s["n"], db, kind(s, db))

    def traffic(s, knobs, db):
        m, k, n = s["m"], s["k"], s["n"]
        t = gemm_plans.traffic(m, k, n, db, knobs, extra_bytes(m, k, n, db),
                               extra_flops(m, k, n), kind(s, db))
        inter = (m * k if name == "rmsnorm_matmul" else m * n) * db
        return dataclasses.replace(t, saved_bytes=2.0 * inter)

    def own(s, db):
        if db != 2:
            return {}
        return gemm_plans.own_plan(name, s["m"], s["k"], s["n"], db)

    return pipeline.KernelDef(name, traffic, space, own_plan=own)


for _d in (
    _gemm_def("rmsnorm_matmul", lambda m, k, n, db: k * db,
              lambda m, k, n: 4.0 * m * k),
    _gemm_def("matmul_residual_add", lambda m, k, n, db: m * n * db,
              lambda m, k, n: float(m * n)),
    _gemm_def("matmul_bias_act", lambda m, k, n, db: n * db,
              lambda m, k, n: 10.0 * m * n),
):
    pipeline.register(_d)


def _fa_proj_kind(s, db) -> str:
    """The projection runs on the mainloop at any M (its M is B * S, its K
    H * hd) when the kernel takes the shape; the attention core's tiles
    are compile-time (`csrc/attention.cuh`), so otherwise the tune space
    is the one point {}."""
    return ("mainloop" if db == 2 and s["hd"] == HEAD_DIM
            and not s["dm"] % 8 else "fixed")


def _fa_proj_space(s, db):
    return gemm_plans.space(s["b"] * s["s"], s["h"] * s["hd"], s["dm"], db,
                            _fa_proj_kind(s, db))


def _fa_proj_traffic(s, knobs, db):
    b, h, kv, sq, hd, dm = (s[k] for k in ("b", "h", "kv", "s", "hd", "dm"))
    heads = b * sq * h * hd * db            # the head outputs (B, S, H, hd)
    attn_flops = 2.0 * b * h * sq * sq * hd        # causal: half of 4BHS^2hd
    attn_bytes = (b * h * sq * hd + 2 * b * kv * sq * hd) * db - heads
    t = gemm_plans.traffic(b * sq, h * hd, dm, db, knobs, attn_bytes,
                           attn_flops, _fa_proj_kind(s, db))
    return dataclasses.replace(t, saved_bytes=2.0 * heads)


def _fa_proj_own(s, db):
    if _fa_proj_kind(s, db) == "fixed":
        return {}
    return {"tile_n": gemm_plans.wgmma_plan(
        "flash_attention_proj", s["b"] * s["s"], s["dm"])[0]}


pipeline.register(pipeline.KernelDef(
    "flash_attention_proj", _fa_proj_traffic, _fa_proj_space,
    own_plan=_fa_proj_own))

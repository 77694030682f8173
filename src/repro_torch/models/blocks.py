"""Residual block kinds (the port of `repro.models.blocks`).

The dense attention + FFN block ("attn") is ported: specs, full-sequence
`apply`, `cache_specs` and one-token `decode`, on the plain route and on
the fused route (KernelPolicy mode "fused"), with the paged-KV switch.
Every other kind raises NotImplementedError (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.cluster.policy import current_policy

from . import attention as attn_lib
from .layers import (ParamSpec, apply_ffn, attn_specs, ffn_specs,
                     fused_attention_proj, fused_matmul_residual,
                     fused_norm_matmul, out_project, qkv_postprocess,
                     qkv_project, rms_norm)

F32 = torch.float32


def _norm_specs(cfg, name: str) -> dict:
    if cfg.norm == "rms":
        return {name: ParamSpec((cfg.d_model,), ("norm",), init="zeros")}
    raise NotImplementedError(
        f"norm {cfg.norm!r}: layer norm comes with the other block kinds "
        f"(ROADMAP Queue 1 item 10)")


def _norm(cfg, p, name: str, x):
    return rms_norm(x, p[name])


def attn_block_specs(cfg) -> dict:
    s = {}
    s |= _norm_specs(cfg, "ln_attn")
    s["attn"] = attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
    if cfg.d_ff:
        s |= _norm_specs(cfg, "ln_ffn")
        s["ffn"] = ffn_specs(cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind)
    return s


def _fused_rms(cfg) -> bool:
    """Does this block take the fused producer-consumer route? Steered by
    the active KernelPolicy (mode "fused")."""
    return current_policy().fused and cfg.norm == "rms"


def _fused_qkv(cfg, p, x, ctx):
    """qkv with the pre-attention rmsnorm folded into each projection's
    prologue (the normed activations never round-trip device memory)."""
    a = p["attn"]
    d = x.shape[-1]

    def proj(w):
        y = fused_norm_matmul(x, p["ln_attn"], w.reshape(d, -1))
        return y.reshape(*x.shape[:-1], w.shape[1], w.shape[2])

    return qkv_postprocess(a, proj(a["wq"]), proj(a["wk"]), proj(a["wv"]),
                           ctx["positions"], qkv_bias=cfg.qkv_bias,
                           qk_norm=cfg.qk_norm, rope=ctx.get("rope", True),
                           theta=cfg.rope_theta)


def _fused_out_residual(p, o, x):
    """x + out_project(o) with the residual added in the matmul epilogue."""
    wo = p["attn"]["wo"]
    flat = o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1])
    return fused_matmul_residual(flat, wo.reshape(-1, wo.shape[-1]), x)


def _plain_qkv(cfg, p, x, ctx):
    return qkv_project(p["attn"], _norm(cfg, p, "ln_attn", x),
                       ctx["positions"], n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                       qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                       rope=ctx.get("rope", True), theta=cfg.rope_theta)


def _self_attention(cfg, p, x, ctx, *, window, causal=True):
    if _fused_rms(cfg):
        q, k, v = _fused_qkv(cfg, p, x, ctx)
        if causal and window is None:
            # the whole hot path in one kernel: flash attention with the
            # output projection summed across heads on chip
            return x + fused_attention_proj(q, k, v, p["attn"]["wo"],
                                            causal=True)
        o = attn_lib.attention(q, k, v, n_kv=cfg.n_kv_heads, causal=causal,
                               window=window, chunk=cfg.attn_chunk,
                               schedule=cfg.attn_schedule)
        return _fused_out_residual(p, o, x)
    q, k, v = _plain_qkv(cfg, p, x, ctx)
    o = attn_lib.attention(q, k, v, n_kv=cfg.n_kv_heads, causal=causal,
                           window=window, chunk=cfg.attn_chunk,
                           schedule=cfg.attn_schedule)
    return x + out_project(p["attn"], o)


def _ffn_residual(cfg, p, x):
    """x + FFN(norm(x)); under "fused" the norm is folded into the
    gate/up prologues and the residual into the down-projection
    epilogue."""
    if current_policy().fused and cfg.norm == "rms" \
            and cfg.ffn_kind == "swiglu":
        f = p["ffn"]
        g = fused_norm_matmul(x, p["ln_ffn"], f["w_gate"])
        u = fused_norm_matmul(x, p["ln_ffn"], f["w_up"])
        h = F.silu(g.to(F32)).to(x.dtype) * u
        return fused_matmul_residual(h, f["w_down"], x)
    return x + apply_ffn(p["ffn"], _norm(cfg, p, "ln_ffn", x),
                         kind=cfg.ffn_kind)


def attn_block_apply(cfg, p, x, ctx, *, window=None):
    window = window if window is not None else cfg.window
    x = _self_attention(cfg, p, x, ctx, window=window,
                        causal=ctx.get("causal", True))
    if cfg.d_ff:
        x = _ffn_residual(cfg, p, x)
    return x, 0.0


def attn_cache_specs(cfg, B: int, cache_len: int) -> dict:
    return {
        "k": ParamSpec((B, cache_len, cfg.n_kv_heads, cfg.hd),
                       ("batch", "kv_seq", "kv_heads", None), init="zeros"),
        "v": ParamSpec((B, cache_len, cfg.n_kv_heads, cfg.hd),
                       ("batch", "kv_seq", "kv_heads", None), init="zeros"),
    }


def _paged(ctx, window) -> bool:
    """Route this block's K/V through the shared page pool?"""
    return ctx.get("pages") is not None and not window


def attn_block_decode(cfg, p, x, cache, pos, ctx, *, window=None):
    """One token through the block. `cache` {"k", "v"} is updated in place
    (the reference donates it) and returned."""
    window = window if window is not None else cfg.window
    paged = _paged(ctx, window)
    rolling = (not paged and bool(window)
               and cache["k"].shape[1] < ctx["max_seq"])
    if _fused_rms(cfg):
        q, k, v = _fused_qkv(cfg, p, x, ctx)
    else:
        q, k, v = _plain_qkv(cfg, p, x, ctx)
    if paged:
        kc, vc = attn_lib.paged_update_cache(cache["k"], cache["v"], k, v,
                                             pos, ctx["pages"])
        o = attn_lib.paged_decode_attention(q, kc, vc, pos + 1, ctx["pages"],
                                            n_kv=cfg.n_kv_heads)
    else:
        kc, vc = attn_lib.update_cache(cache["k"], cache["v"], k, v, pos,
                                       rolling=rolling)
        o = attn_lib.decode_attention(q, kc, vc, pos + 1,
                                      n_kv=cfg.n_kv_heads,
                                      window=window, rolling=rolling)
    if _fused_rms(cfg):
        x = _fused_out_residual(p, o, x)
    else:
        x = x + out_project(p["attn"], o)
    if cfg.d_ff:
        x = _ffn_residual(cfg, p, x)
    return x, {"k": kc, "v": vc}


def _not_ported(kind: str):
    def fail(*_, **__):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP Queue 1 "
            f"item 10)")
    return fail


BLOCKS = {
    "attn": dict(specs=attn_block_specs, apply=attn_block_apply,
                 cache=attn_cache_specs, decode=attn_block_decode),
}
for _kind in ("local_attn", "attn_moe", "cross", "attn_cross", "enc_attn",
              "rglru", "mlstm", "slstm"):
    BLOCKS[_kind] = dict(specs=_not_ported(_kind), apply=_not_ported(_kind),
                         cache=_not_ported(_kind),
                         decode=_not_ported(_kind))

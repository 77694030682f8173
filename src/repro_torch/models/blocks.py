"""Residual block kinds (the port of `repro.models.blocks`).

Ported: the dense attention + FFN block ("attn": specs, full-sequence
`apply`, `cache_specs` and one-token `decode`, on the plain route and on
the fused route of KernelPolicy mode "fused", with the paged-KV switch);
whisper's two kinds: the encoder block ("enc_attn", bidirectional, its
gelu MLP on the fused route under "fused") and the decoder block
("attn_cross": causal self-attention, cross-attention to the encoder
output, the MLP; decode on private caches or with its self K/V paged);
and the MoE block ("attn_moe": the attn block's attention, then a top-k
expert SwiGLU with capacity, in global or per-row dispatch; a windowed
arch keeps private rolling caches). Every other kind raises
NotImplementedError (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.cluster.policy import current_policy

from . import attention as attn_lib
from .layers import (ParamSpec, _mm, apply_ffn, attn_specs, ffn_specs,
                     fused_attention_proj, fused_matmul_bias_act,
                     fused_matmul_residual, fused_norm_matmul, layer_norm,
                     out_project, product, qkv_postprocess, qkv_project,
                     rms_norm)

F32 = torch.float32


def _norm_specs(cfg, name: str) -> dict:
    if cfg.norm == "rms":
        return {name: ParamSpec((cfg.d_model,), ("norm",), init="zeros")}
    return {name + "_s": ParamSpec((cfg.d_model,), ("norm",), init="ones"),
            name + "_b": ParamSpec((cfg.d_model,), ("norm",), init="zeros")}


def _norm(cfg, p, name: str, x):
    """rms_norm with p[name], or layer_norm with p[name + "_s" / "_b"] (the
    reference's `_norm` and `_ln`, which compute the same)."""
    if cfg.norm == "rms":
        return rms_norm(x, p[name])
    return layer_norm(x, p[name + "_s"], p[name + "_b"])


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
    """qkv with the pre-attention rmsnorm fused into each projection
    (`fused_norm_matmul`)."""
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
            # the whole hot path in one call: flash attention, then the
            # output projection summed across heads in one GEMM
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
    """x + FFN(norm(x)); under "fused" a swiglu MLP folds the rmsnorm into
    the gate/up prologues and the residual into the down-projection
    epilogue, and a gelu MLP takes the bias + activation epilogue on both
    of its products."""
    if current_policy().fused:
        f = p["ffn"]
        if cfg.norm == "rms" and cfg.ffn_kind == "swiglu":
            g = fused_norm_matmul(x, p["ln_ffn"], f["w_gate"])
            u = fused_norm_matmul(x, p["ln_ffn"], f["w_up"])
            h = F.silu(g.to(F32)).to(x.dtype) * u
            return fused_matmul_residual(h, f["w_down"], x)
        if cfg.ffn_kind == "gelu":
            h = fused_matmul_bias_act(_norm(cfg, p, "ln_ffn", x), f["w_in"],
                                      f["b_in"], "gelu")
            return x + fused_matmul_bias_act(h, f["w_out"], f["b_out"],
                                             "none")
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


# ----------------------------------------------------------------------------
# Whisper: the decoder block ("attn_cross") and the encoder block ("enc_attn")
# ----------------------------------------------------------------------------

def attn_cross_block_specs(cfg) -> dict:
    s = {}
    s |= _norm_specs(cfg, "ln_self")
    s["self"] = attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           qkv_bias=cfg.qkv_bias)
    s |= _norm_specs(cfg, "ln_cross")
    s["cross"] = attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            qkv_bias=cfg.qkv_bias)
    s |= _norm_specs(cfg, "ln_ffn")
    s["ffn"] = ffn_specs(cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind)
    return s


def _self_qkv(cfg, p, x, ctx):
    """The decoder's self-attention projections: no rope (whisper's
    positions are learned and added to the embeddings)."""
    return qkv_project(p["self"], _norm(cfg, p, "ln_self", x),
                       ctx["positions"], n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                       qkv_bias=cfg.qkv_bias, rope=False)


def _cross_q(cfg, p, x):
    qc = _mm(_norm(cfg, p, "ln_cross", x), p["cross"]["wq"],
             "bsd,dhk->bshk")
    return qc + p["cross"]["bq"] if cfg.qkv_bias else qc


def attn_cross_block_apply(cfg, p, x, ctx):
    """Causal self-attention, cross-attention to ctx["cross_embeds"] (the
    encoder output), then the MLP. The MLP is `apply_ffn` under every
    policy: the reference's decoder takes no fused kernel."""
    q, k, v = _self_qkv(cfg, p, x, ctx)
    o = attn_lib.attention(q, k, v, n_kv=cfg.n_kv_heads, causal=True,
                           chunk=cfg.attn_chunk, schedule=cfg.attn_schedule)
    x = x + out_project(p["self"], o)
    enc = ctx["cross_embeds"]
    kc = _mm(enc, p["cross"]["wk"], "bsd,dhk->bshk")
    vc = _mm(enc, p["cross"]["wv"], "bsd,dhk->bshk")
    if cfg.qkv_bias:
        kc, vc = kc + p["cross"]["bk"], vc + p["cross"]["bv"]
    o = attn_lib.cross_attention(_cross_q(cfg, p, x), kc, vc,
                                 n_kv=cfg.n_kv_heads, chunk=cfg.attn_chunk)
    x = x + out_project(p["cross"], o)
    x = x + apply_ffn(p["ffn"], _norm(cfg, p, "ln_ffn", x),
                      kind=cfg.ffn_kind)
    return x, 0.0


def attn_cross_cache_specs(cfg, B: int, cache_len: int) -> dict:
    self_c = attn_cache_specs(cfg, B, cache_len)
    cross = ParamSpec((B, cfg.enc_seq, cfg.n_kv_heads, cfg.hd),
                      ("batch", None, "kv_heads", None), init="zeros")
    return {"self_k": self_c["k"], "self_v": self_c["v"],
            "cross_k": cross, "cross_v": cross}


def attn_cross_block_decode(cfg, p, x, cache, pos, ctx):
    """One token through the decoder block, its cache updated in place.
    Under a page table (`ctx["pages"]`) the self K/V go through the shared
    pool; the cross K/V stay private and are read as they stand: nothing
    fills them from the encoder (zeros from init, as in the reference;
    ROADMAP Queue 3)."""
    q, k, v = _self_qkv(cfg, p, x, ctx)
    if _paged(ctx, None):
        kc, vc = attn_lib.paged_update_cache(cache["self_k"],
                                             cache["self_v"], k, v, pos,
                                             ctx["pages"])
        o = attn_lib.paged_decode_attention(q, kc, vc, pos + 1, ctx["pages"],
                                            n_kv=cfg.n_kv_heads)
    else:
        kc, vc = attn_lib.update_cache(cache["self_k"], cache["self_v"], k,
                                       v, pos)
        o = attn_lib.decode_attention(q, kc, vc, pos + 1,
                                      n_kv=cfg.n_kv_heads)
    x = x + out_project(p["self"], o)
    o = attn_lib.decode_attention(_cross_q(cfg, p, x), cache["cross_k"],
                                  cache["cross_v"], cfg.enc_seq,
                                  n_kv=cfg.n_kv_heads)
    x = x + out_project(p["cross"], o)
    x = x + apply_ffn(p["ffn"], _norm(cfg, p, "ln_ffn", x),
                      kind=cfg.ffn_kind)
    return x, {"self_k": kc, "self_v": vc, "cross_k": cache["cross_k"],
               "cross_v": cache["cross_v"]}


def enc_attn_block_apply(cfg, p, x, ctx):
    """Bidirectional self-attention (direct), then the MLP through
    `_ffn_residual`, which under "fused" is whisper's matmul_bias_act
    path."""
    q, k, v = qkv_project(p["attn"], _norm(cfg, p, "ln_attn", x),
                          ctx["positions"], n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          qkv_bias=cfg.qkv_bias, rope=False)
    o = attn_lib.attention(q, k, v, n_kv=cfg.n_kv_heads, causal=False,
                           schedule="direct")
    x = x + out_project(p["attn"], o)
    return _ffn_residual(cfg, p, x), 0.0


# ----------------------------------------------------------------------------
# MoE block ("attn_moe"): attention + top-k expert FFN (scatter dispatch)
# ----------------------------------------------------------------------------

def moe_specs(cfg) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": ParamSpec((d, E), ("embed", None), dtype=F32),
        "w_gate": ParamSpec((E, d, f), ("expert", "embed", "ffn")),
        "w_up": ParamSpec((E, d, f), ("expert", "embed", "ffn")),
        "w_down": ParamSpec((E, f, d), ("expert", "ffn", "embed")),
    }


def moe_block_specs(cfg) -> dict:
    s = {}
    s |= _norm_specs(cfg, "ln_attn")
    s["attn"] = attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
    s |= _norm_specs(cfg, "ln_ffn")
    s["moe"] = moe_specs(cfg)
    return s


def _route(cfg, p, x):
    """Router logits in f32, softmax, then top-k renormalised with a floor
    of 1e-9. x: (..., d) -> probs (..., E), top_p and top_e (..., K)."""
    logits = product("...d,de->...e", x.to(F32), p["router"], F32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _slots(e_flat, E: int, C: int):
    """Each (token, k) slot's place in its expert's capacity: the count of
    earlier slots routed to the same expert (an exclusive cumsum over the
    slots), and whether it is under the capacity C. The one-hot is laid
    out expert-major, (..., E, slots), so that the cumsum runs along the
    contiguous axis: down 16,384 rows of 8 columns (mixtral's S=8192
    prefill) the scan took 2.8 ms a layer on an H100."""
    onehot = (e_flat[..., None, :] == torch.arange(
        E, device=e_flat.device)[:, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    pos = torch.gather(pos, -2, e_flat[..., None, :].long())[..., 0, :]
    return pos.long(), pos < C


def _experts(p, xe, eq_in: str, eq_out: str):
    """The expert SwiGLU, batched over the experts, in xe's dtype."""
    g = product(eq_in, xe, p["w_gate"], xe.dtype)
    u = product(eq_in, xe, p["w_up"], xe.dtype)
    h = F.silu(g.to(F32)).to(xe.dtype) * u
    return product(eq_out, h, p["w_down"], xe.dtype)


def _aux(cfg, probs, top_e, dims):
    """The Switch load-balancing loss: E * sum_e f_e / K * p_e."""
    E, K = cfg.n_experts, cfg.top_k
    routed = (top_e[..., None] == torch.arange(E, device=top_e.device)
              ).to(F32).sum(-2)
    f_e = routed.mean(dim=dims)
    p_e = probs.mean(dim=dims)
    return E * torch.sum(f_e / K * p_e)


def moe_apply(cfg, p, x):
    """Top-k MoE with capacity; dispatch by scatter and gather (the
    reference's `moe_apply`). Global dispatch (the default) takes capacity
    over the flattened B*S tokens; `cfg.moe_local_dispatch` takes it per
    batch row (`_moe_apply_local`).

    Every shape is static and nothing leaves the device, so a CUDA graph
    can capture it: a slot at or past the capacity C is written to a
    scratch column C of the (E, C + 1) table and dropped with it (the
    reference's out-of-range scatter), and row T of the token table is a
    pad row of zeros."""
    if cfg.moe_local_dispatch:
        return _moe_apply_local(cfg, p, x)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = max(int(K * T * cfg.capacity_factor / E), 1)
    xt = x.reshape(T, d)
    probs, top_p, top_e = _route(cfg, p, xt)
    e_flat = top_e.reshape(-1)                                   # (T*K,)
    pos, keep = _slots(e_flat, E, C)
    tok_idx = torch.arange(T * K, device=x.device) // K          # (T*K,)
    dispatch = torch.full((E, C + 1), T, dtype=torch.int64, device=x.device)
    dispatch[e_flat, torch.clamp(pos, max=C)] = tok_idx
    xp = torch.cat([xt, xt.new_zeros(1, d)])                     # pad row
    ye = _experts(p, xp[dispatch[:, :C]], "ecd,edf->ecf",
                  "ecf,efd->ecd")                                # (E, C, d)
    ys = ye[e_flat, torch.clamp(pos, max=C - 1)]                 # (T*K, d)
    w_slot = (top_p.reshape(-1) * keep).to(ys.dtype)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add_(
        0, tok_idx, ys * w_slot[:, None])
    return y.reshape(B, S, d), _aux(cfg, probs, top_e, (0,))


def _moe_apply_local(cfg, p, x):
    """Grouped dispatch: capacity, table and combine per batch row."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(int(K * S * cfg.capacity_factor / E), 1)
    probs, top_p, top_e = _route(cfg, p, x)                      # (B, S, .)
    e_flat = top_e.reshape(B, S * K)
    pos, keep = _slots(e_flat, E, C)
    tok_idx = torch.arange(S * K, device=x.device) // K          # (S*K,)
    rows = torch.arange(B, device=x.device)[:, None]
    table = torch.full((B, E, C + 1), S, dtype=torch.int64, device=x.device)
    table[rows, e_flat, torch.clamp(pos, max=C)] = tok_idx.expand(B, -1)
    xp = torch.cat([x, x.new_zeros(B, 1, d)], dim=1)             # pad rows
    xe = xp[rows[:, :, None], table[:, :, :C]]                   # (B,E,C,d)
    ye = _experts(p, xe, "becd,edf->becf", "becf,efd->becd")
    ys = ye[rows, e_flat, torch.clamp(pos, max=C - 1)]           # (B,S*K,d)
    w_slot = (top_p.reshape(B, S * K) * keep).to(ye.dtype)
    flat = (rows * S + tok_idx).reshape(-1)
    y = torch.zeros((B * S, d), dtype=ye.dtype, device=x.device).index_add_(
        0, flat, (ys * w_slot[..., None]).reshape(-1, d))
    return y.reshape(B, S, d).to(x.dtype), _aux(cfg, probs, top_e, (0, 1))


def moe_block_apply(cfg, p, x, ctx):
    x = _self_attention(cfg, p, x, ctx, window=cfg.window)
    y, aux = moe_apply(cfg, p["moe"], _norm(cfg, p, "ln_ffn", x))
    return x + y, aux


def moe_block_decode(cfg, p, x, cache, pos, ctx):
    """One token: the plain qkv and out projections under every policy,
    as the reference's `moe_block_decode` has them, then the MoE FFN with
    T = B tokens."""
    paged = _paged(ctx, cfg.window)
    rolling = (not paged and bool(cfg.window)
               and cache["k"].shape[1] < ctx["max_seq"])
    q, k, v = qkv_project(p["attn"], _norm(cfg, p, "ln_attn", x),
                          ctx["positions"], n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                          theta=cfg.rope_theta)
    if paged:
        kc, vc = attn_lib.paged_update_cache(cache["k"], cache["v"], k, v,
                                             pos, ctx["pages"])
        o = attn_lib.paged_decode_attention(q, kc, vc, pos + 1, ctx["pages"],
                                            n_kv=cfg.n_kv_heads)
    else:
        kc, vc = attn_lib.update_cache(cache["k"], cache["v"], k, v, pos,
                                       rolling=rolling)
        o = attn_lib.decode_attention(q, kc, vc, pos + 1, n_kv=cfg.n_kv_heads,
                                      window=cfg.window, rolling=rolling)
    x = x + out_project(p["attn"], o)
    y, _ = moe_apply(cfg, p["moe"], _norm(cfg, p, "ln_ffn", x))
    return x + y, {"k": kc, "v": vc}


def _not_ported(kind: str):
    def fail(*_, **__):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP Queue 1 "
            f"item 10)")
    return fail


BLOCKS = {
    "attn": dict(specs=attn_block_specs, apply=attn_block_apply,
                 cache=attn_cache_specs, decode=attn_block_decode),
    "attn_cross": dict(specs=attn_cross_block_specs,
                       apply=attn_cross_block_apply,
                       cache=attn_cross_cache_specs,
                       decode=attn_cross_block_decode),
    # the encoder block's parameters are the attn block's (whisper has no
    # qk-norm and an MLP)
    "enc_attn": dict(specs=attn_block_specs, apply=enc_attn_block_apply,
                     cache=None, decode=None),
    "attn_moe": dict(specs=moe_block_specs, apply=moe_block_apply,
                     cache=attn_cache_specs, decode=moe_block_decode),
}
for _kind in ("local_attn", "cross", "rglru", "mlstm", "slstm"):
    BLOCKS[_kind] = dict(specs=_not_ported(_kind), apply=_not_ported(_kind),
                         cache=_not_ported(_kind),
                         decode=_not_ported(_kind))

"""Residual block kinds (the port of `repro.models.blocks`).

Every kind of the reference's registry is ported, each with its specs,
full-sequence `apply`, `cache_specs` and one-token `decode`:

* "attn", the dense attention + FFN block, on the plain route and on the
  fused route of KernelPolicy mode "fused", with the paged-KV switch; and
  "local_attn", the same block with `window=cfg.window` on a cache of
  min(L, window) rows that rolls (recurrentgemma);
* whisper's "enc_attn" (bidirectional, its gelu MLP fused under "fused")
  and "attn_cross" (causal self-attention, cross-attention to the encoder
  output, the MLP; decode on private caches or with its self K/V paged);
* "attn_moe": the attn block's attention, then a top-k expert SwiGLU with
  capacity, in global or per-row dispatch;
* "cross" (llama-3.2-vision): tanh-gated cross-attention to the image
  embeddings with q/k norms, and its gated FFN, both on the plain route
  under every policy, as in the reference;
* the recurrent kinds: "rglru" (RG-LRU, recurrentgemma), "mlstm" (the
  chunkwise matrix-memory LSTM) and "slstm" (the scalar-memory LSTM, a
  sequential scan), xlstm's two.

A decode writes its new state into the layer's view of the cache, in
place (`copy_`, as `attention.update_cache` does): the decode step
discards what a block returns, and a captured CUDA graph writes to the
addresses it was captured on, so no decode allocates a state tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.cluster.policy import current_policy
from repro_torch.kernels.ref import ACTIVATIONS

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
    """x + FFN(norm(x)); under "fused" a swiglu or geglu MLP folds the
    rmsnorm into the gate/up prologues and the residual into the
    down-projection epilogue, and a gelu MLP takes the bias + activation
    epilogue on both of its products."""
    if current_policy().fused:
        f = p["ffn"]
        if cfg.norm == "rms" and cfg.ffn_kind in ("swiglu", "geglu"):
            g = fused_norm_matmul(x, p["ln_ffn"], f["w_gate"])
            u = fused_norm_matmul(x, p["ln_ffn"], f["w_up"])
            act = F.silu if cfg.ffn_kind == "swiglu" else ACTIVATIONS["gelu"]
            h = act(g.to(F32)).to(x.dtype) * u
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


# ----------------------------------------------------------------------------
# Cross-attention block ("cross"): llama-3.2-vision's image layers
# ----------------------------------------------------------------------------

def cross_block_specs(cfg) -> dict:
    s = {}
    s |= _norm_specs(cfg, "ln_attn")
    s["attn"] = attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           qk_norm=True)
    s["gate_attn"] = ParamSpec((1,), ("norm",), dtype=F32, init="zeros")
    s["gate_ffn"] = ParamSpec((1,), ("norm",), dtype=F32, init="zeros")
    s |= _norm_specs(cfg, "ln_ffn")
    s["ffn"] = ffn_specs(cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind)
    return s


def _image_q(cfg, p, x):
    q = _mm(_norm(cfg, p, "ln_attn", x), p["attn"]["wq"], "bsd,dhk->bshk")
    return rms_norm(q, p["attn"]["q_norm"])


def _gated_tail(cfg, p, x, o):
    """x + tanh(gate_attn) * out_project(o), then + tanh(gate_ffn) * FFN;
    the gates are f32 parameters, rounded to x's dtype after the tanh."""
    ga = torch.tanh(p["gate_attn"]).to(x.dtype)
    gf = torch.tanh(p["gate_ffn"]).to(x.dtype)
    x = x + ga * out_project(p["attn"], o)
    y = apply_ffn(p["ffn"], _norm(cfg, p, "ln_ffn", x), kind=cfg.ffn_kind)
    return x + gf * y


def cross_block_apply(cfg, p, x, ctx):
    """Cross-attention of the text to ctx["cross_embeds"] (the image
    embeddings, taken as they come), k normed after its projection."""
    emb = ctx["cross_embeds"]
    k = rms_norm(_mm(emb, p["attn"]["wk"], "bsd,dhk->bshk"),
                 p["attn"]["k_norm"])
    v = _mm(emb, p["attn"]["wv"], "bsd,dhk->bshk")
    o = attn_lib.cross_attention(_image_q(cfg, p, x), k, v,
                                 n_kv=cfg.n_kv_heads, chunk=cfg.attn_chunk)
    return _gated_tail(cfg, p, x, o), 0.0


def cross_cache_specs(cfg, B: int, cache_len: int) -> dict:
    n_ctx = cfg.n_img_tokens or cfg.enc_seq
    spec = ParamSpec((B, n_ctx, cfg.n_kv_heads, cfg.hd),
                     ("batch", None, "kv_heads", None), init="zeros")
    return {"k": spec, "v": spec}


def cross_block_decode(cfg, p, x, cache, pos, ctx):
    """One token against the cached image K/V, read as they stand: nothing
    fills them (zeros from init, as in the reference, and as whisper's
    cross K/V)."""
    o = attn_lib.decode_attention(_image_q(cfg, p, x), cache["k"],
                                  cache["v"], cache["k"].shape[1],
                                  n_kv=cfg.n_kv_heads)
    return _gated_tail(cfg, p, x, o), cache


# ----------------------------------------------------------------------------
# RG-LRU recurrent block ("rglru"): recurrentgemma / Griffin
# ----------------------------------------------------------------------------

def rglru_block_specs(cfg) -> dict:
    d, r = cfg.d_model, cfg.lru_width
    s = {}
    s |= _norm_specs(cfg, "ln_rec")
    s["w_x"] = ParamSpec((d, r), ("embed", "ffn"))
    s["w_gate"] = ParamSpec((d, r), ("embed", "ffn"))
    s["conv_w"] = ParamSpec((cfg.conv_width, r), ("conv", "ffn"), scale=0.5)
    s["w_ra"] = ParamSpec((r, r), ("ffn", None))       # recurrence gate
    s["b_ra"] = ParamSpec((r,), ("ffn",), init="zeros")
    s["w_ix"] = ParamSpec((r, r), ("ffn", None))       # input gate
    s["b_ix"] = ParamSpec((r,), ("ffn",), init="zeros")
    s["lam"] = ParamSpec((r,), ("ffn",), dtype=F32, init="ones", scale=1.0)
    s["w_out"] = ParamSpec((r, d), ("ffn", "embed"))
    s |= _norm_specs(cfg, "ln_ffn")
    s["ffn"] = ffn_specs(cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind)
    return s


def _causal_conv(x, w, state=None):
    """Depthwise causal convolution in x's dtype. x: (B, S, r); w: (W, r);
    state: the (B, W-1, r) inputs before x, or None (zeros). The taps are
    added in the reference's order, each product and each sum rounded.
    Returns y and the last W-1 inputs (None without a state)."""
    W, S = w.shape[0], x.shape[1]
    ext = (torch.cat([state, x], dim=1) if state is not None
           else F.pad(x, (0, 0, W - 1, 0)))
    y = ext[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + ext[:, i:i + S] * w[i]
    return y, (ext[:, -(W - 1):] if state is not None else None)


def _rglru_gates(p, u):
    """log a (< 0) and the input gate, f32: each gate's product rounded to
    u's dtype, then cast to f32, as the reference rounds it."""
    r = torch.sigmoid(_mm(u, p["w_ra"], "...r,rs->...s").to(F32) + p["b_ra"])
    i = torch.sigmoid(_mm(u, p["w_ix"], "...r,rs->...s").to(F32) + p["b_ix"])
    return -8.0 * F.softplus(p["lam"]) * r, i


def _rglru_inputs(cfg, p, x, conv_state=None):
    """The gelu output gate, a and b of h_t = a_t h_(t-1) + b_t (f32), and
    the new convolution state."""
    h = _norm(cfg, p, "ln_rec", x)
    gate = ACTIVATIONS["gelu"](_mm(h, p["w_gate"], "bsd,dr->bsr").to(F32))
    u, conv = _causal_conv(_mm(h, p["w_x"], "bsd,dr->bsr"), p["conv_w"],
                           conv_state)
    log_a, i_gate = _rglru_gates(p, u)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i_gate * u.to(F32))
    return gate, torch.exp(log_a), b, conv


def linear_scan(a, b):
    """h_t = a_t h_(t-1) + b_t along axis 1 from h = 0, for every t: a
    log-depth doubling scan (after the pass at distance d, (a_t, b_t) is
    the composition of the steps t-2d+1 .. t). It multiplies a's, never
    sums their logarithms: exp(cumsum(log a)) underflows where the log
    reaches thousands below zero. a and b are consumed."""
    S, d = a.shape[1], 1
    while d < S:
        b[:, d:] += a[:, d:] * b[:, :-d]
        if 2 * d < S:
            a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return b


def rglru_block_apply(cfg, p, x, ctx):
    gate, a, b, _ = _rglru_inputs(cfg, p, x)
    y = (gate * linear_scan(a, b)).to(x.dtype)
    x = x + _mm(y, p["w_out"], "bsr,rd->bsd")
    return _ffn_residual(cfg, p, x), 0.0


def rglru_cache_specs(cfg, B: int, cache_len: int) -> dict:
    r = cfg.lru_width
    return {"h": ParamSpec((B, r), ("batch", "ffn"), dtype=F32, init="zeros"),
            "conv": ParamSpec((B, cfg.conv_width - 1, r),
                              ("batch", None, "ffn"), init="zeros")}


def rglru_block_decode(cfg, p, x, cache, pos, ctx):
    """One step of the recurrence: h (f32) and the convolution's last
    inputs (x's dtype) are written into the cache in place."""
    gate, a, b, conv = _rglru_inputs(cfg, p, x, cache["conv"])
    h = a[:, 0] * cache["h"] + b[:, 0]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv)
    y = (gate[:, 0] * h).to(x.dtype)[:, None]
    x = x + _mm(y, p["w_out"], "bsr,rd->bsd")
    return _ffn_residual(cfg, p, x), cache


# ----------------------------------------------------------------------------
# mLSTM block ("mlstm"): xLSTM's matrix memory, chunkwise
# ----------------------------------------------------------------------------

def mlstm_block_specs(cfg) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    di = H * hd
    s = {}
    s |= _norm_specs(cfg, "ln")
    s["w_up"] = ParamSpec((d, 2 * di), ("embed", "ffn"))
    s["conv_w"] = ParamSpec((cfg.conv_width, di), ("conv", "ffn"), scale=0.5)
    s["wq"] = ParamSpec((di, H, hd), ("ffn", "heads", None))
    s["wk"] = ParamSpec((di, H, hd), ("ffn", "heads", None))
    s["wv"] = ParamSpec((di, H, hd), ("ffn", "heads", None))
    s["w_i"] = ParamSpec((di, H), ("ffn", "heads"), dtype=F32)
    s["b_i"] = ParamSpec((H,), ("heads",), dtype=F32, init="zeros")
    s["w_f"] = ParamSpec((di, H), ("ffn", "heads"), dtype=F32)
    s["b_f"] = ParamSpec((H,), ("heads",), dtype=F32, init="ones", scale=1.0)
    s["ogate_ln"] = ParamSpec((H, hd), ("heads", None), init="zeros")
    s["w_down"] = ParamSpec((di, d), ("ffn", "embed"))
    return s


def _mlstm_qkvif(cfg, p, x, conv_state=None):
    """x: (B, S, d) -> the output gate, q, k, v (B, S, H, hd), the log
    input and forget gates li, lf (B, S, H) in f32 (their products in f32,
    as the reference runs them) and the new convolution state."""
    up = _mm(_norm(cfg, p, "ln", x), p["w_up"], "bsd,de->bse")
    gate, main = up.chunk(2, dim=-1)
    main, conv = _causal_conv(main, p["conv_w"], conv_state)
    main = F.silu(main.to(F32)).to(x.dtype)
    q = _mm(main, p["wq"], "bse,ehk->bshk")
    k = _mm(main, p["wk"], "bse,ehk->bshk")
    v = _mm(main, p["wv"], "bse,ehk->bshk")
    mf = main.to(F32)
    li = product("bse,eh->bsh", mf, p["w_i"], F32) + p["b_i"]
    lf = F.logsigmoid(product("bse,eh->bsh", mf, p["w_f"], F32) + p["b_f"])
    return gate, q, k, v, li, lf, conv


def _mlstm_chunk(q, k, v, li, lf, C0, n0, m0, scale):
    """One chunk of the stabilised chunkwise mLSTM, in f32. q, k, v: (B,
    c, H, hd); li, lf: (B, c, H); the carried state C0 (B, H, hd, hd), n0
    (B, H, hd), m0 (B, H). Returns (h, C1, n1, m1). Every product has two
    operands: the reference's three-operand sums are taken as a pairwise
    product first."""
    c = q.shape[1]
    Fc = torch.cumsum(lf, dim=1)                                # (B,c,H)
    # the decay of key s seen from query t: F_t - F_s + li_s for s <= t
    D = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    D = torch.where(tri[None, :, :, None], D, float("-inf"))
    m_inter = m0[:, None, :] + Fc                               # (B,t,H)
    m_t = torch.clamp(torch.maximum(D.amax(dim=2), m_inter), min=-1e30)

    qs, kf, vf = q.to(F32) * scale, k.to(F32), v.to(F32)
    scw = torch.einsum("bthd,bshd->btsh", qs, kf) \
        * torch.exp(D - m_t[:, :, None, :])
    h_intra = torch.einsum("btsh,bshd->bthd", scw, vf)
    n_intra = torch.einsum("btsh,bshd->bthd", scw, kf)
    dec = torch.exp(m_inter - m_t)                              # (B,t,H)
    h_inter = torch.einsum("bthd,bhde->bthe", qs, C0) * dec[..., None]
    n_inter = torch.einsum("bthd,bhd->bth", qs, n0) * dec
    qn = torch.einsum("bthd,bthd->bth", qs, n_intra) + n_inter
    den = torch.maximum(torch.abs(qn), torch.exp(-m_t))
    h = (h_intra + h_inter) / den[..., None]

    F_tot = Fc[:, -1, :]                                        # (B,H)
    m_kv = F_tot[:, None, :] - Fc + li                          # (B,s,H)
    m1 = torch.maximum(m0 + F_tot, m_kv.amax(dim=1))
    w_kv = torch.exp(m_kv - m1[:, None, :])
    carry = torch.exp(m0 + F_tot - m1)
    wk = w_kv[..., None] * kf
    C1 = carry[..., None, None] * C0 + torch.einsum("bshd,bshe->bhde", wk, vf)
    n1 = carry[..., None] * n0 + wk.sum(dim=1)
    return h, C1, n1, m1


def _mlstm_out(cfg, p, x, h, gate):
    """The head outputs h (B, S, H, hd) f32 -> x + the down-projection of
    their per-head rmsnorm times silu(gate)."""
    B, S = h.shape[:2]
    h = rms_norm(h.to(x.dtype), p["ogate_ln"])
    h = h.reshape(B, S, -1) * F.silu(gate.to(F32)).to(x.dtype)
    return x + _mm(h, p["w_down"], "bse,ed->bsd")


def mlstm_block_apply(cfg, p, x, ctx):
    """Chunks of c = min(attn_chunk, S) rows (S a multiple of c, as the
    reference's reshape needs), the state carried from chunk to chunk
    from C = 0, n = 0, m = -1e30."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    gate, q, k, v, li, lf, _ = _mlstm_qkvif(cfg, p, x)
    c = min(cfg.attn_chunk, S)
    if S % c:
        raise ValueError(f"mlstm: S={S} is not a multiple of the chunk {c}")
    C = torch.zeros((B, H, hd, hd), dtype=F32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=F32, device=x.device)
    m = torch.full((B, H), -1e30, dtype=F32, device=x.device)
    hs = []
    for t0 in range(0, S, c):
        blk = slice(t0, t0 + c)
        h, C, n, m = _mlstm_chunk(q[:, blk], k[:, blk], v[:, blk],
                                  li[:, blk], lf[:, blk], C, n, m,
                                  hd ** -0.5)
        hs.append(h)
    return _mlstm_out(cfg, p, x, torch.cat(hs, dim=1), gate), 0.0


def mlstm_cache_specs(cfg, B: int, cache_len: int) -> dict:
    H, hd = cfg.n_heads, cfg.hd
    return {"C": ParamSpec((B, H, hd, hd), ("batch", "heads", None, None),
                           dtype=F32, init="zeros"),
            "n": ParamSpec((B, H, hd), ("batch", "heads", None), dtype=F32,
                           init="zeros"),
            "m": ParamSpec((B, H), ("batch", "heads"), dtype=F32,
                           init="zeros"),
            "conv": ParamSpec((B, cfg.conv_width - 1, H * hd),
                              ("batch", None, "ffn"), init="zeros")}


def mlstm_block_decode(cfg, p, x, cache, pos, ctx):
    """The stabilised single step; C, n, m and the convolution state are
    written into the cache in place (a fresh cache starts m at 0, as the
    reference's does)."""
    gate, q, k, v, li, lf, conv = _mlstm_qkvif(cfg, p, x, cache["conv"])
    q, k, v, li, lf = (t[:, 0] for t in (q, k, v, li, lf))
    m1 = torch.maximum(lf + cache["m"], li)
    fd = torch.exp(lf + cache["m"] - m1)
    idc = torch.exp(li - m1)
    kf = k.to(F32)
    C1 = fd[..., None, None] * cache["C"] + idc[..., None, None] \
        * (kf[..., :, None] * v.to(F32)[..., None, :])
    n1 = fd[..., None] * cache["n"] + idc[..., None] * kf
    qs = q.to(F32) * cfg.hd ** -0.5
    num = torch.einsum("bhd,bhde->bhe", qs, C1)
    den = torch.maximum(torch.abs((qs * n1).sum(dim=-1)), torch.exp(-m1))
    cache["C"].copy_(C1)
    cache["n"].copy_(n1)
    cache["m"].copy_(m1)
    cache["conv"].copy_(conv)
    h = (num / den[..., None])[:, None]                         # (B,1,H,hd)
    return _mlstm_out(cfg, p, x, h, gate), cache


# ----------------------------------------------------------------------------
# sLSTM block ("slstm"): xLSTM's scalar memory, a sequential scan
# ----------------------------------------------------------------------------

def slstm_block_specs(cfg) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    di = H * hd
    s = {}
    s |= _norm_specs(cfg, "ln")
    s["w_in"] = ParamSpec((d, 4 * di), ("embed", "ffn"))       # i, f, z, o
    s["r_h"] = ParamSpec((4, H, hd, hd), (None, "heads", None, None))
    s["b"] = ParamSpec((4 * di,), ("ffn",), init="zeros")
    s["w_out"] = ParamSpec((di, d), ("ffn", "embed"))
    return s


def _slstm_scan(cfg, p, z_in, state):
    """z_in: (B, S, 4 * di); state: [c, n, m, h], each (B, H, hd) f32. One
    step a row of S, the recurrent product with r_h in f32. Returns the
    h of every step (B, S, H, hd) and the last state."""
    B, S, _ = z_in.shape
    H, hd = cfg.n_heads, cfg.hd
    r_h = p["r_h"].to(F32)
    c, n, m, h = state
    hs = []
    for t in range(S):
        zt = z_in[:, t].reshape(B, 4, H, hd).to(F32) \
            + torch.einsum("bhd,ghde->bghe", h, r_h)
        i_r, f_r, z_r, o_r = zt.unbind(dim=1)
        lf = F.logsigmoid(f_r)
        m1 = torch.maximum(lf + m, i_r)
        fd = torch.exp(lf + m - m1)
        idc = torch.exp(i_r - m1)
        c = fd * c + idc * torch.tanh(z_r)
        n = fd * n + idc
        h = torch.sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
        m = m1
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


def _slstm_in(cfg, p, x):
    return _mm(_norm(cfg, p, "ln", x), p["w_in"], "bsd,de->bse") + p["b"]


def _slstm_out(p, x, hs):
    B, S = hs.shape[:2]
    y = hs.reshape(B, S, -1).to(x.dtype)
    return x + _mm(y, p["w_out"], "bse,ed->bsd")


def slstm_block_apply(cfg, p, x, ctx):
    """The scan from c = n = h = 0 and m = -1e30."""
    B = x.shape[0]
    zero = torch.zeros((B, cfg.n_heads, cfg.hd), dtype=F32, device=x.device)
    hs, _ = _slstm_scan(cfg, p, _slstm_in(cfg, p, x),
                        [zero, zero, zero - 1e30, zero])
    return _slstm_out(p, x, hs), 0.0


def slstm_cache_specs(cfg, B: int, cache_len: int) -> dict:
    spec = ParamSpec((B, cfg.n_heads, cfg.hd), ("batch", "heads", None),
                     dtype=F32, init="zeros")
    return {"c": spec, "n": spec, "m": spec, "h": spec}


def slstm_block_decode(cfg, p, x, cache, pos, ctx):
    """One step of the scan from the cached c, n, m, h (a fresh cache
    starts m at 0, as the reference's does), written back in place."""
    keys = ("c", "n", "m", "h")
    hs, state = _slstm_scan(cfg, p, _slstm_in(cfg, p, x),
                            [cache[k] for k in keys])
    for k, t in zip(keys, state):
        cache[k].copy_(t)
    return _slstm_out(p, x, hs), cache


# ----------------------------------------------------------------------------
# Kind registry
# ----------------------------------------------------------------------------

BLOCKS = {
    "attn": dict(specs=attn_block_specs, apply=attn_block_apply,
                 cache=attn_cache_specs, decode=attn_block_decode),
    "local_attn": dict(
        specs=attn_block_specs,
        apply=lambda cfg, p, x, ctx: attn_block_apply(cfg, p, x, ctx,
                                                      window=cfg.window),
        cache=lambda cfg, B, L: attn_cache_specs(
            cfg, B, min(L, cfg.window or L)),
        decode=lambda cfg, p, x, c, pos, ctx: attn_block_decode(
            cfg, p, x, c, pos, ctx, window=cfg.window)),
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
    "cross": dict(specs=cross_block_specs, apply=cross_block_apply,
                  cache=cross_cache_specs, decode=cross_block_decode),
    "rglru": dict(specs=rglru_block_specs, apply=rglru_block_apply,
                  cache=rglru_cache_specs, decode=rglru_block_decode),
    "mlstm": dict(specs=mlstm_block_specs, apply=mlstm_block_apply,
                  cache=mlstm_cache_specs, decode=mlstm_block_decode),
    "slstm": dict(specs=slstm_block_specs, apply=slstm_block_apply,
                  cache=slstm_cache_specs, decode=slstm_block_decode),
}

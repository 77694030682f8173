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
  capacity, in global or per-row dispatch; with the block context's
  "dispatch_group" (the sharded train step's batch ranks) the dispatch
  spans the tokens of every batch rank;
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

With a `ModelAxis` under the block context's "model_axis" (the
tensor-parallel train step, `steps.forward(axis=)`, and the sharded
serving steps) every kind computes the splits the plan makes over the
"model" axis, which GSPMD derives for the reference: each rank its query
heads (and its KV heads, or the KV heads its query heads read) of a
self-, cross- or encoder attention, its d_ff columns of an FFN (swiglu,
geglu or whisper's gelu MLP) or of every expert, its channels of the
RG-LRU recurrence. A split sub-block's input enters through
`collectives.copy_to_ranks` and its partial output leaves through
`collectives.reduce_from_ranks`, the residual (and an output bias)
added once, on model rank 0; a gated sub-block (vision's cross) sums
its partials in f32 before its gate multiplies the sum (`_row_sum`);
the RG-LRU's two gate products, split on their input channels, sum
their partials with a reduce-scatter (`collectives.scatter_from_ranks`). A sub-block the plan keeps whole
(xlstm's mLSTM and sLSTM under its own rules, heads the model size does
not divide) runs as it does on one device, on every rank, with no
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.cluster.policy import current_policy
from repro_torch.core import collectives
from repro_torch.kernels.ref import ACTIVATIONS

from . import attention as attn_lib
from .layers import (ParamSpec, _mm, apply_ffn, attn_specs, ffn_specs,
                     fused_attention_proj, fused_matmul_bias_act,
                     fused_matmul_residual, fused_norm_matmul, gelu_mlp,
                     layer_norm, out_project, product, qkv_postprocess,
                     qkv_project, rms_norm, wide)

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


# ----------------------------------------------------------------------------
# The model axis (the tensor-parallel train step)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """What the plan splits over the "model" axis, for this rank: its
    coordinate `rank` of `size` on the axis and the axis's process group;
    the query heads (`heads`), KV heads (`kv_heads`) and vocabulary rows
    (`vocab`) and channels of the RG-LRU's width (`lru`) it owns (a
    slice of the whole dim; None where the plan keeps the dim whole), and
    whether a dense FFN's d_ff (`ffn`) and the experts' d_ff
    (`expert_ffn`) are split. The lru width and d_ff are both logical
    "ffn", but a model size may divide one and not the other. xLSTM's
    blocks take `inner`, the rank's channels of the inner width di (the
    mLSTM's conv and q / k / v / gate rows, the down projections' rows),
    and `cell_heads`, its heads of the mLSTM / sLSTM cells (None: every
    head, on every rank). A split dim is split also at size 1: the plan
    names the axis, and the step runs its collectives (identities
    there)."""
    group: Any
    rank: int
    size: int
    heads: slice | None = None
    kv_heads: slice | None = None
    ffn: bool = False
    expert_ffn: bool = False
    vocab: slice | None = None
    lru: slice | None = None
    inner: slice | None = None
    cell_heads: slice | None = None
    cache: "CacheSplit | None" = None


@dataclasses.dataclass(frozen=True)
class CacheSplit:
    """How the plan splits a decode cache's K/V leaves over "model", for
    this rank (`steps.cache_split`): `rows`, this rank's rows of a
    private cache of `cache_len` rows where kv_seq is split (None: whole);
    `heads`, the KV heads its private cache holds where kv_heads is split
    instead (None: all); `pool_heads`, the KV heads its block of the paged
    pool holds (None: all); `cross_heads`, the KV heads its block of a
    cross-attention cache (whisper's cross K/V, vision's image K/V:
    ("batch", None, "kv_heads", None)) holds (None: all)."""
    cache_len: int
    rows: slice | None = None
    heads: slice | None = None
    pool_heads: slice | None = None
    cross_heads: slice | None = None


def _copy_in(axis, p: dict, prefix) -> dict:
    """`p` with each leaf whose name starts with `prefix` (a str or a
    tuple of them: a norm's scale and bias, a gate) through
    `copy_to_ranks`: read inside a split computation, its gradient is
    summed over the model ranks."""
    return {k: collectives.copy_to_ranks(v, axis.group)
            if k.startswith(prefix) else v for k, v in p.items()}


def _partial_out(axis, part, res):
    """The sum over the model ranks (`reduce_from_ranks`) of this rank's
    partial `part` of a row-parallel output, the residual `res` (the
    copied input, so that its gradient too is summed once) added into
    model rank 0's partial before the sum. At one rank: res + part."""
    return collectives.reduce_from_ranks(
        res + part if axis.rank == 0 else part, axis.group)


def _split_heads(axis) -> bool:
    """Does `axis` split the query heads (the attention sub-blocks then
    compute this rank's heads)?"""
    return axis is not None and axis.heads is not None


def _attn_view(p: dict, key: str, norm: str) -> dict:
    """The attention sub-block `key` of p and its norm `norm` under the
    attn block's names ("attn", "ln_attn"...), for the split attention
    code (whisper's decoder self-attention)."""
    view = {"attn": p[key]}
    for tail in ("", "_s", "_b"):
        if norm + tail in p:
            view["ln_attn" + tail] = p[norm + tail]
    return view


def _kv_read(cfg, heads: slice):
    """The KV heads that query heads `heads` read (h -> h // (H / KV)): a
    slice when each of them serves an equal run of the local query heads
    (the kernel's GQA grouping), else one index a query head."""
    g = cfg.n_heads // cfg.n_kv_heads
    kv = [h // g for h in range(heads.start, heads.stop)]
    lo, n, n_q = kv[0], kv[-1] + 1 - kv[0], len(kv)
    if n_q % n == 0 and all(kv[i] - lo == i // (n_q // n)
                            for i in range(n_q)):
        return slice(lo, lo + n)
    return kv


def _split_attn(cfg, a: dict, axis: ModelAxis) -> dict:
    """This rank's attention parameters: wq, bq and wo hold its query
    heads as the plan splits them; where the plan keeps the KV heads
    whole, wk / wv (bk / bv) are cut to the KV heads its query heads read.
    Every leaf the rank reads but does not own (the qk-norm scales, whole
    KV weights) comes through `copy_to_ranks`."""
    copy = lambda t: collectives.copy_to_ranks(t, axis.group)
    a = {k: copy(v) if k in ("q_norm", "k_norm") else v for k, v in a.items()}
    if axis.kv_heads is None:
        read = _kv_read(cfg, axis.heads)
        for k in ("wk", "wv", "bk", "bv"):
            if k in a:
                a[k] = (copy(a[k])[:, read] if k[0] == "w"
                        else copy(a[k])[read])
    return a


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
    axis = ctx.get("model_axis")
    if _split_heads(axis):
        return _split_self_attention(cfg, p, x, ctx, axis, window=window,
                                     causal=causal)
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


def _split_self_attention(cfg, p, x, ctx, axis, *, window, causal,
                          schedule=None):
    """`_self_attention` on this rank's query heads: x and the norm's
    scale enter through `copy_to_ranks`; the rank projects its q, k and v
    heads, attends and projects its heads' rows of wo into a partial of
    the output, which `reduce_from_ranks` sums over the model ranks. The
    residual is added once, on model rank 0, into its partial before the
    sum (the copied x, so that its gradient too is summed once); where a
    fused kernel adds the residual in its epilogue, the other ranks give
    it zeros. `schedule` pins the attention's schedule (whisper's
    encoder: "direct"; None: the config's). At one rank this is
    `_self_attention`'s arithmetic (and `enc_attn_block_apply`'s), bit
    for bit."""
    xc = collectives.copy_to_ranks(x, axis.group)
    lp = _copy_in(axis, p, "ln_attn")
    lp["attn"] = _split_attn(cfg, p["attn"], axis)
    res = xc if axis.rank == 0 else None
    if _fused_rms(cfg):
        q, k, v = _fused_qkv(cfg, lp, xc, ctx)
        if causal and window is None:
            part = fused_attention_proj(q, k, v, lp["attn"]["wo"],
                                        causal=True)
            part = part if res is None else res + part
        else:
            o = attn_lib.attention(q, k, v, n_kv=k.shape[2], causal=causal,
                                   window=window, chunk=cfg.attn_chunk,
                                   schedule=cfg.attn_schedule)
            part = _fused_out_residual(
                lp, o, torch.zeros_like(xc) if res is None else res)
    else:
        q, k, v = _plain_qkv(cfg, lp, xc, ctx)
        o = attn_lib.attention(q, k, v, n_kv=k.shape[2], causal=causal,
                               window=window, chunk=cfg.attn_chunk,
                               schedule=schedule or cfg.attn_schedule)
        part = out_project(lp["attn"], o)
        part = part if res is None else res + part
    return collectives.reduce_from_ranks(part, axis.group)


def _ffn_route(cfg) -> str:
    """The route `_ffn_residual` takes under the active policy: "norm_matmul"
    (a swiglu or geglu MLP after an rmsnorm under "fused": the norm in
    the gate/up prologues (row 1), the residual in the down projection's
    epilogue (row 2)), "bias_act" (a gelu MLP under "fused": row 7 on
    both products) or "plain"."""
    if current_policy().fused:
        if cfg.norm == "rms" and cfg.ffn_kind in ("swiglu", "geglu"):
            return "norm_matmul"
        if cfg.ffn_kind == "gelu":
            return "bias_act"
    return "plain"


def _split_ffn_residual(cfg, p, x, axis, route: str):
    """`_ffn_residual` on this rank's d_ff columns, by `route`
    (`_ffn_route`; whisper's decoder MLP is "plain" under every policy):
    x and the norm's scale enter through `copy_to_ranks`, gate and up
    (or w_in and b_in) are column slices, the down projection (w_out) a
    row slice whose partial product `reduce_from_ranks` sums.

    * "norm_matmul": row 1 at N = d_ff / model; row 2 takes the partial
      with the residual in its epilogue, the copied x on model rank 0
      and zeros on the others: row 5 (`ops.matmul`) has no autograd
      Function, so under grad it could not take the partial alone, and
      at one rank row 2 rounds bf16(bf16(h @ W) + x) as the unsplit
      block does.
    * "bias_act": row 7 at N = d_ff / model, then at K = d_ff / model
      with the output bias b_out on model rank 0 and zeros elsewhere.
    * "plain": the MLP's products on the columns; a gelu MLP's b_out
      goes into model rank 0's partial only (bf16(h @ W) + b_out, then
      + x, as the unsplit block rounds them).

    b_out, read on one rank but whole on each, enters through
    `copy_to_ranks` as the residual does: its gradient is rank 0's, on
    every rank. The other ranks add it times 0: every rank's copy then
    takes a gradient, so that each issues the copy's all-reduce in
    backward (a copy no gradient reached would skip it on those ranks
    alone, and the ranks' collectives would part)."""
    xc = collectives.copy_to_ranks(x, axis.group)
    lp = _copy_in(axis, p, "ln_ffn")
    f = p["ffn"]
    first = axis.rank == 0
    if route == "norm_matmul":
        g = fused_norm_matmul(xc, lp["ln_ffn"], f["w_gate"])
        u = fused_norm_matmul(xc, lp["ln_ffn"], f["w_up"])
        act = F.silu if cfg.ffn_kind == "swiglu" else ACTIVATIONS["gelu"]
        h = act(g.to(F32)).to(x.dtype) * u
        return collectives.reduce_from_ranks(fused_matmul_residual(
            h, f["w_down"], xc if first else torch.zeros_like(xc)),
            axis.group)
    n = _norm(cfg, lp, "ln_ffn", xc)
    if cfg.ffn_kind == "gelu":
        b_out = collectives.copy_to_ranks(f["b_out"], axis.group)
        b_out = b_out if first else b_out * 0
        if route == "bias_act":
            h = fused_matmul_bias_act(n, f["w_in"], f["b_in"], "gelu")
            part = fused_matmul_bias_act(h, f["w_out"], b_out, "none")
        else:
            part = gelu_mlp(n, f["w_in"], f["b_in"], f["w_out"], b_out)
    else:
        part = apply_ffn(f, n, kind=cfg.ffn_kind)
    return _partial_out(axis, part, xc)


def _ffn_residual(cfg, p, x, axis: ModelAxis | None = None,
                  route: str | None = None):
    """x + FFN(norm(x)); under "fused" a swiglu or geglu MLP folds the
    rmsnorm into the gate/up prologues and the residual into the
    down-projection epilogue, and a gelu MLP takes the bias + activation
    epilogue on both of its products (`route`, "plain" for whisper's
    decoder, which takes no fused kernel under any policy, as in the
    reference; None: `_ffn_route`). With `axis` splitting d_ff, this
    rank's columns (`_split_ffn_residual`)."""
    route = route or _ffn_route(cfg)
    if axis is not None and axis.ffn:
        return _split_ffn_residual(cfg, p, x, axis, route)
    f = p["ffn"]
    if route == "norm_matmul":
        g = fused_norm_matmul(x, p["ln_ffn"], f["w_gate"])
        u = fused_norm_matmul(x, p["ln_ffn"], f["w_up"])
        act = F.silu if cfg.ffn_kind == "swiglu" else ACTIVATIONS["gelu"]
        h = act(g.to(F32)).to(x.dtype) * u
        return fused_matmul_residual(h, f["w_down"], x)
    if route == "bias_act":
        h = fused_matmul_bias_act(_norm(cfg, p, "ln_ffn", x), f["w_in"],
                                  f["b_in"], "gelu")
        return x + fused_matmul_bias_act(h, f["w_out"], f["b_out"], "none")
    return x + apply_ffn(f, _norm(cfg, p, "ln_ffn", x), kind=cfg.ffn_kind)


def attn_block_apply(cfg, p, x, ctx, *, window=None):
    window = window if window is not None else cfg.window
    x = _self_attention(cfg, p, x, ctx, window=window,
                        causal=ctx.get("causal", True))
    if cfg.d_ff:
        x = _ffn_residual(cfg, p, x, ctx.get("model_axis"))
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


def _paged_write(ctx, k_pool, v_pool, k, v, pos):
    """`paged_update_cache` of this step's rows. With ctx["pool_group"]
    (a mesh whose batch axes split the slots while every batch rank
    holds the whole pool, as the plan places it) the rows, positions and
    page tables of every batch rank are gathered first
    (``pool_all_gather``), so that each rank's pool takes every slot's
    write, as the reference's replicated pool does."""
    group = ctx.get("pool_group")
    pages = ctx["pages"]
    if group is not None:
        b = k.shape[0]
        pos_b = attn_lib.per_slot(pos, b, k.device)
        rows = collectives.all_gather_dim(torch.cat([k, v], dim=2), 0,
                                          group, name="pool_all_gather")
        idx = collectives.all_gather_dim(
            torch.cat([pos_b[:, None].to(pages.dtype), pages], dim=1), 0,
            group, name="pool_all_gather")
        k, v = rows.split(k.shape[2], dim=2)
        pos, pages = idx[:, 0], idx[:, 1:]
    return attn_lib.paged_update_cache(k_pool, v_pool, k, v, pos, pages)


def _attention_decode(cfg, p, x, cache, pos, ctx, *, window, fused: bool):
    """The attention half of a decode step -> (x after the attention's
    residual, new cache {"k", "v"}); `fused` takes the fused qkv and out
    projections (the attn block under "fused"), else the plain ones."""
    axis = ctx.get("model_axis")
    if axis is not None and axis.cache is not None:
        return _split_attention_decode(cfg, p, x, cache, pos, ctx, axis,
                                       window=window, fused=fused)
    paged = _paged(ctx, window)
    rolling = (not paged and bool(window)
               and cache["k"].shape[1] < ctx["max_seq"])
    q, k, v = (_fused_qkv if fused else _plain_qkv)(cfg, p, x, ctx)
    if paged:
        kc, vc = _paged_write(ctx, cache["k"], cache["v"], k, v, pos)
        o = attn_lib.paged_decode_attention(q, kc, vc, pos + 1, ctx["pages"],
                                            n_kv=cfg.n_kv_heads)
    else:
        kc, vc = attn_lib.update_cache(cache["k"], cache["v"], k, v, pos,
                                       rolling=rolling)
        o = attn_lib.decode_attention(q, kc, vc, pos + 1,
                                      n_kv=cfg.n_kv_heads,
                                      window=window, rolling=rolling)
    if fused:
        x = _fused_out_residual(p, o, x)
    else:
        x = x + out_project(p["attn"], o)
    return x, {"k": kc, "v": vc}


def _split_attention_decode(cfg, p, x, cache, pos, ctx, axis, *, window,
                            fused: bool):
    """`_attention_decode` on this rank's blocks (no autograd: serving
    runs under inference_mode). The rank projects its query heads (all
    of them where the plan keeps the heads whole) and the KV heads its
    parameters hold. Its cache block then decides the rest:

    * rows split (kv_seq over "model", a private cache): the rank needs
      every query head and every KV head's new row, so q, k and v are
      gathered over the model ranks (one ``heads_all_gather`` of the
      three; nothing where the plan keeps both whole); it writes the rows
      that fall in its block (`update_cache_block`), attends over its
      block for every head (`decode_attention_block`) and the blocks are
      combined (`combine_blocks`: ``lse_max`` and ``lse_sum`` on B x H,
      ``lse_out`` on the B x H x hd outputs in f32); it keeps its query
      heads' rows of the output. A layer: one all_gather, three
      all_reduces and the out-projection's reduce_from_ranks. A
      reduce-scatter of ``lse_out`` over the heads would hand each rank
      only its heads (1 / model of those bytes); the all_reduce keeps
      one combine for every split of the heads (whole heads included).
    * KV heads split (a private cache whose rows the model size does not
      divide, or the paged pool): the rank's query heads read its own KV
      heads, with no collective.
    * neither (the plan keeps the cache whole): every rank writes every
      KV head's row (gathered where the parameters split them) and
      attends for its query heads over the KV heads they read.

    The out-projection of the rank's heads' rows of wo is a partial that
    `reduce_from_ranks` sums, the residual added on model rank 0 (zeros
    elsewhere where row 2's epilogue takes it). At one rank every step is
    the unsplit block's arithmetic, bit for bit."""
    split = axis.cache
    paged = _paged(ctx, window)
    a = p["attn"]
    own_heads = axis.heads is not None
    q, k, v = (_fused_qkv if fused else _plain_qkv)(cfg, p, x, ctx)
    if paged:
        cache_heads = split.pool_heads
        rows = None
    else:
        cache_heads, rows = split.heads, split.rows
    kv_all = cache_heads is None           # the cache block holds every KV head
    gather_q = rows is not None and own_heads
    gather_kv = kv_all and axis.kv_heads is not None
    if gather_q or gather_kv:
        parts = ([q] if gather_q else []) + ([k, v] if gather_kv else [])
        whole = collectives.all_gather_dim(
            torch.cat(parts, dim=2)[None], 0, axis.group,
            name="heads_all_gather")                 # (model, B, 1, n, hd)
        sizes = [t.shape[2] for t in parts]
        pieces = whole.split(sizes, dim=3)
        flat = [pc.movedim(0, 2).reshape(*pc.shape[1:3], -1, pc.shape[-1])
                for pc in pieces]
        if gather_q:
            q_all = flat.pop(0)
        if gather_kv:
            k, v = flat
    if not gather_q:
        q_all = q
    if paged:
        kc, vc = _paged_write(ctx, cache["k"], cache["v"], k, v, pos)
        kg = attn_lib.paged_gather(kc, ctx["pages"])
        vg = attn_lib.paged_gather(vc, ctx["pages"])
        o = _heads_attention(cfg, q, kg, vg, pos, axis, kv_all,
                             window=None, rolling=False)
    elif rows is not None:
        rolling = bool(window) and split.cache_len < ctx["max_seq"]
        kc, vc = attn_lib.update_cache_block(
            cache["k"], cache["v"], k, v, pos, offset=rows.start,
            cache_len=split.cache_len, rolling=rolling)
        ob, m, sm = attn_lib.decode_attention_block(
            q_all, kc, vc, pos + 1, n_kv=cfg.n_kv_heads,
            offset=rows.start, cache_len=split.cache_len, window=window,
            rolling=rolling)
        o = attn_lib.combine_blocks(ob, m, sm, axis.group)
        if own_heads:
            o = o[:, :, axis.heads]
    else:
        rolling = (bool(window)
                   and cache["k"].shape[1] < ctx["max_seq"])
        kc, vc = attn_lib.update_cache(cache["k"], cache["v"], k, v, pos,
                                       rolling=rolling)
        o = _heads_attention(cfg, q, kc, vc, pos, axis, kv_all,
                             window=window, rolling=rolling)
    if not own_heads:
        if fused:
            return _fused_out_residual(p, o, x), {"k": kc, "v": vc}
        return x + out_project(a, o), {"k": kc, "v": vc}
    res = x if axis.rank == 0 else None
    if fused:
        part = _fused_out_residual(
            p, o, torch.zeros_like(x) if res is None else res)
    else:
        part = out_project(a, o)
        part = part if res is None else res + part
    return (collectives.reduce_from_ranks(part, axis.group),
            {"k": kc, "v": vc})


def _heads_attention(cfg, q, kc, vc, pos, axis, kv_all: bool, *, window,
                     rolling: bool):
    """`decode_attention` of this rank's query heads `q` against cache
    rows `kc` / `vc` that hold every KV head (`kv_all`: the query heads
    read theirs, `_kv_read`) or the rank's own KV heads."""
    if not kv_all or axis.heads is None:
        return attn_lib.decode_attention(q, kc, vc, pos + 1,
                                         n_kv=kc.shape[2], window=window,
                                         rolling=rolling)
    read = _kv_read(cfg, axis.heads)
    n = (read.stop - read.start) if isinstance(read, slice) else len(read)
    return attn_lib.decode_attention(q, kc[:, :, read], vc[:, :, read],
                                     pos + 1, n_kv=n, window=window,
                                     rolling=rolling)


def attn_block_decode(cfg, p, x, cache, pos, ctx, *, window=None):
    """One token through the block. `cache` {"k", "v"} is updated in place
    (the reference donates it) and returned. Under a `ModelAxis` with a
    `CacheSplit` in ctx["model_axis"] (the sharded decode step) the rank
    computes its blocks (`_split_attention_decode`, `_ffn_residual`)."""
    window = window if window is not None else cfg.window
    x, new = _attention_decode(cfg, p, x, cache, pos, ctx, window=window,
                               fused=_fused_rms(cfg))
    if cfg.d_ff:
        x = _ffn_residual(cfg, p, x, ctx.get("model_axis"))
    return x, new


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


def _enc_kv(cfg, a, enc):
    """The cross K/V of the encoder output `enc` with the cross weights
    `a` (this rank's KV heads, or those its query heads read, under a
    split)."""
    kc = _mm(enc, a["wk"], "bsd,dhk->bshk")
    vc = _mm(enc, a["wv"], "bsd,dhk->bshk")
    if cfg.qkv_bias:
        kc, vc = kc + a["bk"], vc + a["bv"]
    return kc, vc


def _split_cross_attention(cfg, p, x, enc, axis):
    """Whisper's cross-attention on this rank's query heads: x and the
    norm's scale enter through `copy_to_ranks`; the rank projects its
    query heads of x and its KV heads of the encoder output `enc` (the
    ones its query heads read where the plan keeps the KV heads whole),
    attends and projects its heads' rows of wo into a partial that
    `reduce_from_ranks` sums, the residual on model rank 0. `enc` has
    entered through `copy_to_ranks` once for every layer
    (`steps.forward`): each rank's layers hand the encoder only their own
    heads' share of its gradient."""
    xc = collectives.copy_to_ranks(x, axis.group)
    lp = _copy_in(axis, p, "ln_cross")
    a = lp["cross"] = _split_attn(cfg, p["cross"], axis)
    kc, vc = _enc_kv(cfg, a, enc)
    o = attn_lib.cross_attention(_cross_q(cfg, lp, xc), kc, vc,
                                 n_kv=kc.shape[2], chunk=cfg.attn_chunk)
    return _partial_out(axis, out_project(a, o), xc)


def attn_cross_block_apply(cfg, p, x, ctx):
    """Causal self-attention, cross-attention to ctx["cross_embeds"] (the
    encoder output), then the MLP. The MLP is `apply_ffn` under every
    policy: the reference's decoder takes no fused kernel. Under a model
    axis each sub-block computes this rank's query heads and d_ff
    columns as the plan splits them (`_split_self_attention`,
    `_split_cross_attention`, `_split_ffn_residual`)."""
    axis = ctx.get("model_axis")
    enc = ctx["cross_embeds"]
    if _split_heads(axis):
        x = _split_self_attention(cfg, _attn_view(p, "self", "ln_self"), x,
                                  ctx, axis, window=None, causal=True)
        x = _split_cross_attention(cfg, p, x, enc, axis)
    else:
        q, k, v = _self_qkv(cfg, p, x, ctx)
        o = attn_lib.attention(q, k, v, n_kv=cfg.n_kv_heads, causal=True,
                               chunk=cfg.attn_chunk,
                               schedule=cfg.attn_schedule)
        x = x + out_project(p["self"], o)
        kc, vc = _enc_kv(cfg, p["cross"], enc)
        o = attn_lib.cross_attention(_cross_q(cfg, p, x), kc, vc,
                                     n_kv=cfg.n_kv_heads,
                                     chunk=cfg.attn_chunk)
        x = x + out_project(p["cross"], o)
    return _ffn_residual(cfg, p, x, axis, "plain"), 0.0


def attn_cross_cache_specs(cfg, B: int, cache_len: int) -> dict:
    self_c = attn_cache_specs(cfg, B, cache_len)
    cross = ParamSpec((B, cfg.enc_seq, cfg.n_kv_heads, cfg.hd),
                      ("batch", None, "kv_heads", None), init="zeros")
    return {"self_k": self_c["k"], "self_v": self_c["v"],
            "cross_k": cross, "cross_v": cross}


def _cross_decode(cfg, q, k_cache, v_cache, axis):
    """One token's attention of q against a cross-attention cache read
    whole along its rows (whisper's cross K/V, vision's image K/V). Under
    a model axis (`axis.cache`) q holds this rank's query heads (all
    where the plan keeps them whole) and the cache block the rank's KV
    heads (`cross_heads`) or every KV head, of which the query heads
    read theirs (`_heads_attention`)."""
    n = k_cache.shape[1]
    if axis is None or axis.cache is None:
        return attn_lib.decode_attention(q, k_cache, v_cache, n,
                                         n_kv=cfg.n_kv_heads)
    return _heads_attention(cfg, q, k_cache, v_cache, n - 1, axis,
                            axis.cache.cross_heads is None, window=None,
                            rolling=False)


def _row_sum(axis, eq: str, h, w):
    """`_mm(h, w, eq)` of this rank's rows of w (a row-parallel product)
    summed over the model ranks, rounded once to h's dtype as the unsplit
    product rounds it: the ranks' partials are summed in f32 (at one rank
    the product is rounded as the unsplit block rounds it). A gated
    block's scalar gate reads the sum's every element, and partials
    rounded to bf16 before the sum would move its gradient by several
    times a bf16 run's own error."""
    if axis.size == 1:
        return collectives.reduce_from_ranks(_mm(h, w, eq), axis.group)
    return collectives.reduce_from_ranks(product(eq, h, w, F32),
                                         axis.group).to(h.dtype)


def _row_out(axis, a, o, x, gate=None):
    """x + out_project(o), or x + gate * out_project(o): where `axis`
    splits the heads, this rank's heads' partial summed over the model
    ranks (ungated: the residual on model rank 0, before the sum; gated:
    the partials summed in f32 (`_row_sum`) and the gate multiplying the
    sum, so that every rank computes its whole gradient, the residual
    added after it); whole on every rank where it does not."""
    if gate is None:
        y = out_project(a, o)
        return _partial_out(axis, y, x) if _split_heads(axis) else x + y
    if _split_heads(axis):
        y = _row_sum(axis, "bshk,hkd->bsd", o, a["wo"])
    else:
        y = out_project(a, o)
    return x + gate * y


def attn_cross_block_decode(cfg, p, x, cache, pos, ctx):
    """One token through the decoder block, its cache updated in place.
    Under a page table (`ctx["pages"]`) the self K/V go through the shared
    pool; the cross K/V stay private and are read as they stand: nothing
    fills them from the encoder (zeros from init, as in the reference;
    ROADMAP Queue 3). Under a model axis with a `CacheSplit` (the sharded
    decode step) the self-attention takes `_split_attention_decode` on
    the self cache's block, the cross-attention this rank's query heads
    against its cross cache block (`_cross_decode`) and the MLP its d_ff
    columns."""
    axis = ctx.get("model_axis")
    if axis is not None and axis.cache is not None:
        x, new = _split_attention_decode(
            cfg, _attn_view(p, "self", "ln_self"), x,
            {"k": cache["self_k"], "v": cache["self_v"]}, pos, ctx, axis,
            window=None, fused=False)
        kc, vc = new["k"], new["v"]
    else:
        q, k, v = _self_qkv(cfg, p, x, ctx)
        if _paged(ctx, None):
            kc, vc = _paged_write(ctx, cache["self_k"], cache["self_v"], k,
                                  v, pos)
            o = attn_lib.paged_decode_attention(q, kc, vc, pos + 1,
                                                ctx["pages"],
                                                n_kv=cfg.n_kv_heads)
        else:
            kc, vc = attn_lib.update_cache(cache["self_k"], cache["self_v"],
                                           k, v, pos)
            o = attn_lib.decode_attention(q, kc, vc, pos + 1,
                                          n_kv=cfg.n_kv_heads)
        x = x + out_project(p["self"], o)
    o = _cross_decode(cfg, _cross_q(cfg, p, x), cache["cross_k"],
                      cache["cross_v"], axis)
    x = _row_out(axis, p["cross"], o, x)
    x = _ffn_residual(cfg, p, x, axis, "plain")
    return x, {"self_k": kc, "self_v": vc, "cross_k": cache["cross_k"],
               "cross_v": cache["cross_v"]}


def enc_attn_block_apply(cfg, p, x, ctx):
    """Bidirectional self-attention (direct), then the MLP through
    `_ffn_residual`, which under "fused" is whisper's matmul_bias_act
    path; under a model axis, this rank's heads and d_ff columns."""
    axis = ctx.get("model_axis")
    if _split_heads(axis):
        x = _split_self_attention(cfg, p, x, ctx, axis, window=None,
                                  causal=False, schedule="direct")
    else:
        q, k, v = qkv_project(p["attn"], _norm(cfg, p, "ln_attn", x),
                              ctx["positions"], n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                              qkv_bias=cfg.qkv_bias, rope=False)
        o = attn_lib.attention(q, k, v, n_kv=cfg.n_kv_heads, causal=False,
                               schedule="direct")
        x = x + out_project(p["attn"], o)
    return _ffn_residual(cfg, p, x, axis), 0.0


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


def _slots(e_flat, E: int, C: int, earlier=None):
    """Each (token, k) slot's place among this rank's slots of its expert
    (an exclusive cumsum over the slots), and whether its place in the
    expert's capacity C is under C: that place is the local one plus
    `earlier`, each expert's count of slots on the ranks before this one
    (None: no other ranks). The one-hot is laid out expert-major,
    (..., E, slots), so that the cumsum runs along the contiguous axis:
    down 16,384 rows of 8 columns (mixtral's S=8192 prefill) the scan took
    2.8 ms a layer on an H100."""
    onehot = (e_flat[..., None, :] == torch.arange(
        E, device=e_flat.device)[:, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    pos = torch.gather(pos, -2, e_flat[..., None, :].long())[..., 0, :]
    pos = pos.long()
    if earlier is None:
        return pos, pos < C
    return pos, pos + earlier[e_flat] < C


def _earlier(e_flat, E: int, group):
    """(E,) the count of slots routed to each expert on the ranks before
    this one in `group` (their tokens come first in the global order).
    The counts are an `index_add_` of ones, `bincount`'s integers with a
    static shape: a dry run's meta trace has no `bincount`."""
    counts = torch.zeros(E, dtype=torch.int64, device=e_flat.device)
    counts.index_add_(0, e_flat.long(), torch.ones_like(e_flat,
                                                        dtype=torch.int64))
    every = collectives.all_gather_dim(counts[None], 0, group,
                                       name="dispatch_all_gather")
    return every[:dist.get_rank(group)].sum(0)


def _experts(p, xe, eq_in: str, eq_out: str, axis=None):
    """The expert SwiGLU, batched over the experts, in xe's dtype. Where
    the plan splits the experts' d_ff over the model axis, each rank
    computes its columns: the dispatched tokens enter through
    `copy_to_ranks` and the partial outputs are summed over the model
    ranks (`reduce_from_ranks`) before the router's weights combine them,
    so the router's gradient is whole and equal on every model rank."""
    split = axis is not None and axis.expert_ffn
    if split:
        xe = collectives.copy_to_ranks(xe, axis.group)
    g = product(eq_in, xe, p["w_gate"], xe.dtype)
    u = product(eq_in, xe, p["w_up"], xe.dtype)
    h = F.silu(g.to(F32)).to(xe.dtype) * u
    y = product(eq_out, h, p["w_down"], xe.dtype)
    return collectives.reduce_from_ranks(y, axis.group) if split else y


def _aux(cfg, probs, top_e, dims, group=None):
    """The Switch load-balancing loss: E * sum_e f_e / K * p_e, each a mean
    over the tokens (of every rank in `group`)."""
    E, K = cfg.n_experts, cfg.top_k
    routed = (top_e[..., None] == torch.arange(E, device=top_e.device)
              ).to(F32).sum(-2)
    if group is None:
        f_e = routed.mean(dim=dims)
        p_e = probs.mean(dim=dims)
    else:
        n = routed[..., 0].numel() * dist.get_world_size(group)
        sums = collectives.sum_over_ranks(
            torch.stack([routed.sum(dim=dims), probs.sum(dim=dims)]), group,
            name="dispatch_all_reduce")
        f_e, p_e = sums[0] / n, sums[1] / n
    return E * torch.sum(f_e / K * p_e)


def moe_apply(cfg, p, x, *, group=None, axis: ModelAxis | None = None):
    """Top-k MoE with capacity; dispatch by scatter and gather (the
    reference's `moe_apply`). Global dispatch (the default) takes capacity
    over the flattened B*S tokens; `cfg.moe_local_dispatch` takes it per
    batch row (`_moe_apply_local`).

    With `group` (the sharded train step's batch ranks) an MoE layer
    dispatches over the tokens of every rank of the group, each rank's
    rows after those of the ranks before it, as the reference's global
    arrays have them: a global dispatch takes its capacity from every
    rank's tokens and places a rank's slots after the earlier ranks' (one
    all_gather of per-expert counts a layer), and both dispatches take
    the load-balance loss's means over every rank's tokens (one
    differentiable all_reduce a layer). `axis` splits the experts' d_ff
    over the model ranks (`_experts`).

    Every shape is static and nothing leaves the device, so a CUDA graph
    can capture it: a slot at or past the capacity C is written to a
    scratch column of the expert's table and dropped with it (the
    reference's out-of-range scatter), and row T of the token table is a
    pad row of zeros. A rank's table has min(C, T*K) columns, its own
    slots' local places (a rank never holds more of an expert's slots)."""
    if cfg.moe_local_dispatch:
        return _moe_apply_local(cfg, p, x, group, axis)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    ranks = 1 if group is None else dist.get_world_size(group)
    C = max(int(K * T * ranks * cfg.capacity_factor / E), 1)
    Ct = min(C, T * K)
    xt = x.reshape(T, d)
    probs, top_p, top_e = _route(cfg, p, xt)
    e_flat = top_e.reshape(-1)                                   # (T*K,)
    earlier = None if group is None else _earlier(e_flat, E, group)
    pos, keep = _slots(e_flat, E, C, earlier)
    tok_idx = torch.arange(T * K, device=x.device) // K          # (T*K,)
    dispatch = torch.full((E, Ct + 1), T, dtype=torch.int64, device=x.device)
    dispatch[e_flat, torch.where(keep, pos, Ct)] = tok_idx
    xp = torch.cat([xt, xt.new_zeros(1, d)])                     # pad row
    ye = _experts(p, xp[dispatch[:, :Ct]], "ecd,edf->ecf",
                  "ecf,efd->ecd", axis)                          # (E, Ct, d)
    ys = ye[e_flat, torch.clamp(pos, max=Ct - 1)]                # (T*K, d)
    w_slot = (top_p.reshape(-1) * keep).to(ys.dtype)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add_(
        0, tok_idx, ys * w_slot[:, None])
    return y.reshape(B, S, d), _aux(cfg, probs, top_e, (0,), group)


def _moe_apply_local(cfg, p, x, group=None, axis=None):
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
    ye = _experts(p, xe, "becd,edf->becf", "becf,efd->becd", axis)
    ys = ye[rows, e_flat, torch.clamp(pos, max=C - 1)]           # (B,S*K,d)
    w_slot = (top_p.reshape(B, S * K) * keep).to(ye.dtype)
    flat = (rows * S + tok_idx).reshape(-1)
    y = torch.zeros((B * S, d), dtype=ye.dtype, device=x.device).index_add_(
        0, flat, (ys * w_slot[..., None]).reshape(-1, d))
    return (y.reshape(B, S, d).to(x.dtype),
            _aux(cfg, probs, top_e, (0, 1), group))


def moe_block_apply(cfg, p, x, ctx):
    x = _self_attention(cfg, p, x, ctx, window=cfg.window)
    y, aux = moe_apply(cfg, p["moe"], _norm(cfg, p, "ln_ffn", x),
                       group=ctx.get("dispatch_group"),
                       axis=ctx.get("model_axis"))
    return x + y, aux


def moe_block_decode(cfg, p, x, cache, pos, ctx):
    """One token: the plain qkv and out projections under every policy,
    as the reference's `moe_block_decode` has them, then the MoE FFN with
    T = B tokens (dispatched over every batch rank's slots with the
    context's "dispatch_group", and the experts' d_ff split by its model
    axis, as in training)."""
    x, new = _attention_decode(cfg, p, x, cache, pos, ctx,
                               window=cfg.window, fused=False)
    y, _ = moe_apply(cfg, p["moe"], _norm(cfg, p, "ln_ffn", x),
                     group=ctx.get("dispatch_group"),
                     axis=ctx.get("model_axis"))
    return x + y, new


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


def _image_kv(a, emb):
    """The image K/V (k normed after its projection) of the embeddings
    `emb` with the attention weights `a`."""
    k = rms_norm(_mm(emb, a["wk"], "bsd,dhk->bshk"), a["k_norm"])
    return k, _mm(emb, a["wv"], "bsd,dhk->bshk")


def _gate(p, name: str, x):
    """tanh of the f32 gate p[name], rounded to x's dtype."""
    return torch.tanh(p[name]).to(x.dtype)


def _gated_ffn(cfg, p, x, axis: ModelAxis | None):
    """x + tanh(gate_ffn) * FFN(norm(x)) on the plain route (a swiglu or
    geglu MLP); with `axis` splitting d_ff, this rank's columns (x and
    the norm's scale through `copy_to_ranks`), the down projection's
    partials summed in f32 over the model ranks (`_row_sum`) before the
    gate multiplies the sum: every rank then computes the gate's whole
    gradient, and the residual stays outside the sum."""
    if axis is None or not axis.ffn:
        y = apply_ffn(p["ffn"], _norm(cfg, p, "ln_ffn", x), kind=cfg.ffn_kind)
    else:
        xc = collectives.copy_to_ranks(x, axis.group)
        lp = _copy_in(axis, p, "ln_ffn")
        f, n = lp["ffn"], _norm(cfg, lp, "ln_ffn", xc)
        g = _mm(n, f["w_gate"], "...d,df->...f")
        u = _mm(n, f["w_up"], "...d,df->...f")
        act = F.silu if cfg.ffn_kind == "swiglu" else ACTIVATIONS["gelu"]
        h = act(g.to(F32)).to(x.dtype) * u
        y = _row_sum(axis, "...f,fd->...d", h, f["w_down"])
    return x + _gate(p, "gate_ffn", x) * y


def cross_block_apply(cfg, p, x, ctx):
    """Cross-attention of the text to ctx["cross_embeds"] (the image
    embeddings, taken as they come), k normed after its projection, then
    x + tanh(gate_attn) * out_project(o) and the gated FFN; the gates are
    f32 parameters, rounded to x's dtype after the tanh. Under a model
    axis splitting the heads the rank projects its query heads and the
    KV heads it owns or reads (`_split_attn`; x, the norm's scale and
    the q/k-norm scales through `copy_to_ranks`), and its partial of the
    out-projection is summed over the ranks before the gate multiplies
    it (`_row_out`); the FFN takes its d_ff columns (`_gated_ffn`)."""
    axis = ctx.get("model_axis")
    emb = ctx["cross_embeds"]
    if _split_heads(axis):
        xc = collectives.copy_to_ranks(x, axis.group)
        lp = _copy_in(axis, p, "ln_attn")
        a = lp["attn"] = _split_attn(cfg, p["attn"], axis)
        k, v = _image_kv(a, emb)
        o = attn_lib.cross_attention(_image_q(cfg, lp, xc), k, v,
                                     n_kv=k.shape[2], chunk=cfg.attn_chunk)
    else:
        a = p["attn"]
        k, v = _image_kv(a, emb)
        o = attn_lib.cross_attention(_image_q(cfg, p, x), k, v,
                                     n_kv=cfg.n_kv_heads,
                                     chunk=cfg.attn_chunk)
    x = _row_out(axis, a, o, x, _gate(p, "gate_attn", x))
    return _gated_ffn(cfg, p, x, axis), 0.0


def cross_cache_specs(cfg, B: int, cache_len: int) -> dict:
    n_ctx = cfg.n_img_tokens or cfg.enc_seq
    spec = ParamSpec((B, n_ctx, cfg.n_kv_heads, cfg.hd),
                     ("batch", None, "kv_heads", None), init="zeros")
    return {"k": spec, "v": spec}


def cross_block_decode(cfg, p, x, cache, pos, ctx):
    """One token against the cached image K/V, read as they stand: nothing
    fills them (zeros from init, as in the reference, and as whisper's
    cross K/V). Under a model axis, this rank's query heads against its
    block of the cache (`_cross_decode`), and its d_ff columns."""
    axis = ctx.get("model_axis")
    o = _cross_decode(cfg, _image_q(cfg, p, x), cache["k"], cache["v"], axis)
    x = _row_out(axis, p["attn"], o, x, _gate(p, "gate_attn", x))
    return _gated_ffn(cfg, p, x, axis), cache


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


def _gate_product(u, w, axis: ModelAxis | None):
    """u @ w (a gate's product, "...r,rs->...s") rounded once to u's
    dtype, as the reference rounds it. Where `axis` splits the lru width
    w holds this rank's rows, its input channels (w_ra and w_ix are
    ("ffn", None)): the rank's product is a partial of every output
    channel, so the partials are summed in f32 over the model ranks and
    each rank keeps its own channels (`collectives.scatter_from_ranks`:
    a reduce-scatter forward, an all-gather of the gradient backward, so
    that u's gradient takes every channel's) before the one rounding. At
    one rank the product is rounded as the unsplit block rounds it."""
    eq = "...r,rs->...s"
    if axis is None or axis.lru is None:
        return _mm(u, w, eq)
    if axis.size == 1:
        return collectives.scatter_from_ranks(_mm(u, w, eq), -1, axis.group)
    return collectives.scatter_from_ranks(product(eq, u, w, F32), -1,
                                          axis.group).to(u.dtype)


def _rglru_gates(p, u, axis: ModelAxis | None = None):
    """log a (< 0) and the input gate, f32: each gate's product rounded to
    u's dtype, then cast to f32, as the reference rounds it."""
    r = torch.sigmoid(_gate_product(u, p["w_ra"], axis).to(F32) + p["b_ra"])
    i = torch.sigmoid(_gate_product(u, p["w_ix"], axis).to(F32) + p["b_ix"])
    return -8.0 * F.softplus(p["lam"]) * r, i


def _rglru_inputs(cfg, p, x, conv_state=None, axis=None):
    """The gelu output gate, a and b of h_t = a_t h_(t-1) + b_t (f32), and
    the new convolution state; with `axis` splitting the lru width, of
    this rank's channels (p its blocks of the leaves)."""
    h = _norm(cfg, p, "ln_rec", x)
    gate = ACTIVATIONS["gelu"](_mm(h, p["w_gate"], "bsd,dr->bsr").to(F32))
    u, conv = _causal_conv(_mm(h, p["w_x"], "bsd,dr->bsr"), p["conv_w"],
                           conv_state)
    log_a, i_gate = _rglru_gates(p, u, axis)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i_gate * u.to(F32))
    return gate, torch.exp(log_a), b, conv


def _lru_split(axis) -> bool:
    return axis is not None and axis.lru is not None


def linear_scan(a, b):
    """h_t = a_t h_(t-1) + b_t along axis 1 from h = 0, for every t: a
    log-depth doubling scan (after the pass at distance d, (a_t, b_t) is
    the composition of the steps t-2d+1 .. t). It multiplies a's, never
    sums their logarithms: exp(cumsum(log a)) underflows where the log
    reaches thousands below zero. Without grad, a and b are consumed
    (each pass writes in place); under grad each pass makes new tensors,
    the same values: autograd keeps the operands each product read, and
    a recomputed layer (torch.utils.checkpoint) cannot see an in-place
    write to them."""
    S, d = a.shape[1], 1
    functional = torch.is_grad_enabled() and (a.requires_grad
                                              or b.requires_grad)
    while d < S:
        if functional:
            b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], 1)
        else:
            b[:, d:] += a[:, d:] * b[:, :-d]
        if 2 * d < S:
            if functional:
                a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
            else:
                a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return b


def rglru_block_apply(cfg, p, x, ctx):
    """The RG-LRU over the sequence, then the MLP. Under a model axis
    splitting the lru width each rank computes its channels: x and
    ln_rec enter through `copy_to_ranks`, w_x / w_gate are column
    slices, the convolution, lam, the gate biases and the scan are per
    channel, the gates' products sum their partials (`_gate_product`),
    and w_out's row partial is summed over the ranks with the residual
    on model rank 0. The MLP takes its d_ff columns."""
    axis = ctx.get("model_axis")
    lp, xin = p, x
    if _lru_split(axis):
        xin = collectives.copy_to_ranks(x, axis.group)
        lp = _copy_in(axis, p, "ln_rec")
    gate, a, b, _ = _rglru_inputs(cfg, lp, xin,
                                  axis=axis if _lru_split(axis) else None)
    y = _mm((gate * linear_scan(a, b)).to(x.dtype), p["w_out"],
            "bsr,rd->bsd")
    x = _partial_out(axis, y, xin) if _lru_split(axis) else x + y
    return _ffn_residual(cfg, p, x, axis), 0.0


def rglru_cache_specs(cfg, B: int, cache_len: int) -> dict:
    r = cfg.lru_width
    return {"h": ParamSpec((B, r), ("batch", "ffn"), dtype=F32, init="zeros"),
            "conv": ParamSpec((B, cfg.conv_width - 1, r),
                              ("batch", None, "ffn"), init="zeros")}


def rglru_block_decode(cfg, p, x, cache, pos, ctx):
    """One step of the recurrence: h (f32) and the convolution's last
    inputs (x's dtype) are written into the cache in place. Under a
    model axis splitting the lru width the cache block holds this rank's
    channels, which it steps with no collective but the gates' sums and
    w_out's partial (`rglru_block_apply`)."""
    axis = ctx.get("model_axis")
    split = _lru_split(axis)
    gate, a, b, conv = _rglru_inputs(cfg, p, x, cache["conv"],
                                     axis if split else None)
    h = a[:, 0] * cache["h"] + b[:, 0]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv)
    y = _mm((gate[:, 0] * h).to(x.dtype)[:, None], p["w_out"],
            "bsr,rd->bsd")
    x = _partial_out(axis, y, x) if split else x + y
    return _ffn_residual(cfg, p, x, axis), cache


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


def _inner_split(axis) -> bool:
    """Does `axis` split xlstm's inner width (its blocks then compute this
    rank's channels)?"""
    return axis is not None and axis.inner is not None


def _cell_sum(axis, eq: str, a, w, out_dtype):
    """`product(eq, a, w, out_dtype)` where `axis` splits the inner width:
    a and w hold this rank's channels of the contraction, so the rank's
    product is a partial of the whole. The partials are summed over the
    model ranks in the heads' dtype (f32, float64 in an f32 run) and
    rounded once to `out_dtype`, as the unsplit product rounds it: where
    the cells' heads split, by a reduce-scatter on the heads (dim 2),
    each rank keeping its own (`scatter_from_ranks`), else by an
    all-reduce (`reduce_from_ranks`; every rank then runs every head).
    At one rank the product is rounded as the unsplit block rounds it."""
    if not _inner_split(axis):
        return product(eq, a, w, out_dtype)
    acc = out_dtype if axis.size == 1 else wide(a.dtype, w.dtype)
    part = product(eq, a, w, acc)
    if axis.cell_heads is not None:
        return collectives.scatter_from_ranks(part, 2, axis.group).to(
            out_dtype)
    return collectives.reduce_from_ranks(part, axis.group).to(out_dtype)


def _mlstm_qkvif(cfg, p, x, conv_state=None, axis=None):
    """x: (B, S, d) -> the output gate, q, k, v (B, S, H, hd), the log
    input and forget gates li, lf (B, S, H) in f32 (their products in f32,
    as the reference runs them; float64 for a float64 x) and the new
    convolution state. Where `axis` splits the inner width (p its blocks
    of the leaves) each rank projects x on its w_up columns and gathers
    the whole (B, S, 2 di) output (gate and main straddle the ranks, and
    the rank's conv channels are another rank's columns), then takes its
    channels of gate and main; q, k, v and the gates sum its partials
    (`_cell_sum`): its heads, or every head."""
    acc = wide(x.dtype)
    up = _mm(_norm(cfg, p, "ln", x), p["w_up"], "bsd,de->bse")
    if _inner_split(axis):
        up = collectives.gather_from_ranks(up, -1, axis.group)
        gate, main = (half[..., axis.inner] for half in up.chunk(2, dim=-1))
    else:
        gate, main = up.chunk(2, dim=-1)
    main, conv = _causal_conv(main, p["conv_w"], conv_state)
    main = F.silu(main.to(acc)).to(x.dtype)
    q = _cell_sum(axis, "bse,ehk->bshk", main, p["wq"], main.dtype)
    k = _cell_sum(axis, "bse,ehk->bshk", main, p["wk"], main.dtype)
    v = _cell_sum(axis, "bse,ehk->bshk", main, p["wv"], main.dtype)
    mf = main.to(acc)
    li = _cell_sum(axis, "bse,eh->bsh", mf, p["w_i"], acc) + p["b_i"]
    lf = F.logsigmoid(_cell_sum(axis, "bse,eh->bsh", mf, p["w_f"], acc)
                      + p["b_f"])
    return gate, q, k, v, li, lf, conv


def _mlstm_chunk(q, k, v, li, lf, C0, n0, m0, scale):
    """One chunk of the stabilised chunkwise mLSTM, in f32 (float64 for
    float64 inputs, an f32 run's; see `mlstm_block_apply`). q, k, v: (B,
    c, H, hd); li, lf: (B, c, H); the carried state C0 (B, H, hd, hd), n0
    (B, H, hd), m0 (B, H). Returns (h, C1, n1, m1). Every product has two
    operands: the reference's three-operand sums are taken as a pairwise
    product first. Each is a `product` in the heads' dtype (an einsum:
    marked for the selective remat policies)."""
    c = q.shape[1]
    acc = wide(q.dtype)
    Fc = torch.cumsum(lf, dim=1)                                # (B,c,H)
    # the decay of key s seen from query t: F_t - F_s + li_s for s <= t
    D = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    D = torch.where(tri[None, :, :, None], D, float("-inf"))
    m_inter = m0[:, None, :] + Fc                               # (B,t,H)
    m_t = torch.clamp(torch.maximum(D.amax(dim=2), m_inter), min=-1e30)

    qs, kf, vf = q.to(acc) * scale, k.to(acc), v.to(acc)
    scw = product("bthd,bshd->btsh", qs, kf, acc) \
        * torch.exp(D - m_t[:, :, None, :])
    h_intra = product("btsh,bshd->bthd", scw, vf, acc)
    n_intra = product("btsh,bshd->bthd", scw, kf, acc)
    dec = torch.exp(m_inter - m_t)                              # (B,t,H)
    h_inter = product("bthd,bhde->bthe", qs, C0, acc) * dec[..., None]
    n_inter = product("bthd,bhd->bth", qs, n0, acc) * dec
    qn = product("bthd,bthd->bth", qs, n_intra, acc) + n_inter
    den = torch.maximum(torch.abs(qn), torch.exp(-m_t))
    h = (h_intra + h_inter) / den[..., None]

    F_tot = Fc[:, -1, :]                                        # (B,H)
    m_kv = F_tot[:, None, :] - Fc + li                          # (B,s,H)
    m1 = torch.maximum(m0 + F_tot, m_kv.amax(dim=1))
    w_kv = torch.exp(m_kv - m1[:, None, :])
    carry = torch.exp(m0 + F_tot - m1)
    wk = w_kv[..., None] * kf
    C1 = carry[..., None, None] * C0 + product("bshd,bshe->bhde", wk, vf,
                                               acc)
    n1 = carry[..., None] * n0 + wk.sum(dim=1)
    return h, C1, n1, m1


def _xlstm_down(axis, h, w, x):
    """x + h @ w ("bse,ed->bsd"). Where `axis` splits the inner width, h
    and w hold this rank's channels: the ranks' partials are summed in
    f32 and rounded once, as the unsplit product rounds it (`_row_sum`:
    bf16 partials rounded apart move the input gate bias's gradient, a
    sum whose terms cancel, by several times its bf16 noise floor), and
    x is the block's input as it came, not its copy into the split
    computation: every rank adds it whole."""
    if not _inner_split(axis):
        return x + _mm(h, w, "bse,ed->bsd")
    return x + _row_sum(axis, "bse,ed->bsd", h, w)


def _mlstm_out(cfg, p, x, h, gate, axis=None):
    """The head outputs h (B, S, H, hd) f32 -> x + the down-projection of
    their per-head rmsnorm times silu(gate). Where `axis` splits the
    inner width, gate and w_down hold this rank's channels: h is its
    heads' (the cells' heads split), or every head's, which enter through
    `copy_to_ranks` after the norm (each rank reads only its channels,
    and the heads every rank computed alike take the whole gradient);
    the down projection's partials are summed over the ranks
    (`_xlstm_down`)."""
    B, S = h.shape[:2]
    h = rms_norm(h.to(x.dtype), p["ogate_ln"]).reshape(B, S, -1)
    if _inner_split(axis) and axis.cell_heads is None:
        h = collectives.copy_to_ranks(h, axis.group)[..., axis.inner]
    h = h * F.silu(gate.to(F32)).to(x.dtype)
    return _xlstm_down(axis, h, p["w_down"], x)


_MLSTM_HEADS = ("ln", "w_up", "conv_w", "wq", "wk", "wv", "w_i", "b_i",
                "w_f", "b_f")


def _xlstm_in(axis, p, x):
    """x and p as a block splitting xlstm's inner width reads them: x and
    the norm's scale (read on every rank, each using its channels of the
    projection) through `copy_to_ranks`; as they are otherwise."""
    if not _inner_split(axis):
        return p, x
    return (_copy_in(axis, p, "ln"),
            collectives.copy_to_ranks(x, axis.group))


def mlstm_block_apply(cfg, p, x, ctx):
    """Chunks of c = min(attn_chunk, S) rows (S a multiple of c, as the
    reference's reshape needs), the state carried from chunk to chunk
    from C = 0, n = 0, m = -1e30. Under a model axis splitting the inner
    width each rank computes its channels and its heads (or every head:
    `_mlstm_qkvif`, `_mlstm_out`)."""
    axis = ctx.get("model_axis")
    axis = axis if _inner_split(axis) else None
    p, xin = _xlstm_in(axis, p, x)
    B, S, _ = x.shape
    hd = cfg.hd
    hp, hx = p, xin
    if x.dtype == torch.float32:
        # an f32 run takes the heads (gates, chunk sums, carried state)
        # in float64: in f32 a head output row whose terms cancel is left
        # ~1e-5 off, the per-head rms norm after it scales its gradient by
        # 1 / rms, and the input gate's bias sums gradients that cancel
        # too. The gates and the chunks' sums alone in float64 leave
        # layer 2's b_i gradient 1.0e-4 from a float64 run (relative L2),
        # and with q, k, v in float64 too it stays above the reference's
        # worst leaf (4.3e-5): the products from the norm through q, k, v
        # and the gates carry the error in (`test_xlstm_f32_gradients_
        # are_within_the_references_error`). bf16 runs keep the
        # reference's f32 arithmetic.
        hp = {n: p[n].double() for n in _MLSTM_HEADS}
        hx = xin.double()
    gate, q, k, v, li, lf, _ = _mlstm_qkvif(cfg, hp, hx, axis=axis)
    H = q.shape[2]
    acc = wide(q.dtype)
    c = min(cfg.attn_chunk, S)
    if S % c:
        raise ValueError(f"mlstm: S={S} is not a multiple of the chunk {c}")
    C = torch.zeros((B, H, hd, hd), dtype=acc, device=x.device)
    n = torch.zeros((B, H, hd), dtype=acc, device=x.device)
    m = torch.full((B, H), -1e30, dtype=acc, device=x.device)
    hs = []
    for t0 in range(0, S, c):
        blk = slice(t0, t0 + c)
        h, C, n, m = _mlstm_chunk(q[:, blk], k[:, blk], v[:, blk],
                                  li[:, blk], lf[:, blk], C, n, m,
                                  hd ** -0.5)
        hs.append(h)
    return _mlstm_out(cfg, p, x, torch.cat(hs, dim=1).to(F32),
                      gate.to(x.dtype), axis), 0.0


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
    reference's does). Under a model axis splitting the inner width the
    cache block holds this rank's conv channels and its heads' (or every
    head's) C, n, m (`steps.cache_shards`)."""
    axis = ctx.get("model_axis")
    axis = axis if _inner_split(axis) else None
    gate, q, k, v, li, lf, conv = _mlstm_qkvif(cfg, p, x, cache["conv"],
                                               axis)
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
    return _mlstm_out(cfg, p, x, h, gate, axis), cache


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
    """z_in: (B, S, 4 * H * hd), the four gates of the heads r_h holds;
    state: [c, n, m, h], each (B, H, hd) f32. One step a row of S, the
    recurrent product with r_h in f32. Returns the h of every step (B, S,
    H, hd) and the last state."""
    B, S, _ = z_in.shape
    r_h = p["r_h"].to(F32)
    H, hd = r_h.shape[1], cfg.hd
    c, n, m, h = state
    hs = []
    for t in range(S):
        zt = z_in[:, t].reshape(B, 4, H, hd).to(F32) \
            + product("bhd,ghde->bghe", h, r_h, F32)
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


def _slstm_in(cfg, p, x, axis=None):
    """The gates' inputs (B, S, 4 di). Where `axis` splits the inner width
    each rank computes its w_in columns plus its b, and the (B, S, 4 di)
    whole is gathered once, before the scan (no collective runs inside
    it); where the cells' heads split too the rank keeps its heads of
    each gate."""
    z = _mm(_norm(cfg, p, "ln", x), p["w_in"], "bsd,de->bse") + p["b"]
    if not _inner_split(axis):
        return z
    z = collectives.gather_from_ranks(z, -1, axis.group)
    if axis.cell_heads is None:
        return z
    B, S = z.shape[:2]
    return z.reshape(B, S, 4, cfg.n_heads, cfg.hd)[
        :, :, :, axis.cell_heads].reshape(B, S, -1)


def _slstm_out(p, x, hs, axis=None):
    """x + hs's output projection. Where `axis` splits the inner width,
    hs is this rank's heads' (the cells' heads split) or every head's, of
    which the rank takes its channels (every rank computed them alike
    from the same z, so each holds the gradient of its channels' share
    only: r_h enters through `copy_to_ranks`, `slstm_block_apply`), and
    w_out's partials are summed over the ranks (`_xlstm_down`)."""
    B, S = hs.shape[:2]
    y = hs.reshape(B, S, -1).to(x.dtype)
    if _inner_split(axis) and axis.cell_heads is None:
        y = y[..., axis.inner]
    return _xlstm_down(axis, y, p["w_out"], x)


def slstm_block_apply(cfg, p, x, ctx):
    """The scan from c = n = h = 0 and m = -1e30. Under a model axis
    splitting the inner width each rank scans its heads with its r_h
    block, or every head with r_h whole (`_slstm_in`, `_slstm_out`)."""
    axis = ctx.get("model_axis")
    axis = axis if _inner_split(axis) else None
    p, xin = _xlstm_in(axis, p, x)
    if axis is not None and axis.cell_heads is None:
        p = _copy_in(axis, p, "r_h")
    z = _slstm_in(cfg, p, xin, axis)
    zero = torch.zeros((x.shape[0], p["r_h"].shape[1], cfg.hd), dtype=F32,
                       device=x.device)
    hs, _ = _slstm_scan(cfg, p, z, [zero, zero, zero - 1e30, zero])
    return _slstm_out(p, x, hs, axis), 0.0


def slstm_cache_specs(cfg, B: int, cache_len: int) -> dict:
    spec = ParamSpec((B, cfg.n_heads, cfg.hd), ("batch", "heads", None),
                     dtype=F32, init="zeros")
    return {"c": spec, "n": spec, "m": spec, "h": spec}


def slstm_block_decode(cfg, p, x, cache, pos, ctx):
    """One step of the scan from the cached c, n, m, h (a fresh cache
    starts m at 0, as the reference's does), written back in place.
    Under a model axis splitting the inner width the cache block holds
    this rank's heads (or every head)."""
    axis = ctx.get("model_axis")
    axis = axis if _inner_split(axis) else None
    keys = ("c", "n", "m", "h")
    hs, state = _slstm_scan(cfg, p, _slstm_in(cfg, p, x, axis),
                            [cache[k] for k in keys])
    for k, t in zip(keys, state):
        cache[k].copy_(t)
    return _slstm_out(p, x, hs, axis), cache


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

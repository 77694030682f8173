"""Attention for the port (the forward half of `repro.models.attention`).

  direct   — materialise the (S x S) scores; small S.
  masked   — q-chunk x kv-chunk blocks with causal masking and an online
             softmax; the same function as `direct` in bounded memory.
  pallas   — the flash_attention kernel (`kernels/flash_attention.py`,
             hand-written CUDA on the GPU) for causal attention without a
             window; anything else falls back to "auto", as the reference
             does. (The reference's folded and banded schedules compute
             the same function again and wait in ROADMAP Queue 1 item 3,
             as does the flash custom VJP, which comes with training.)

`cross_attention` is non-causal attention against a short context
(whisper's encoder output), chunked over q when q is long.

Decode attention over a private or a paged cache is plain tensor code, as
in the reference. GQA is computed in grouped form throughout.
"""

from __future__ import annotations

import numbers

import torch

NEG = -1e30
F32 = torch.float32


def _group(q, n_kv: int):
    """(B, S, H, hd) -> (B, S, KV, G, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _softmax_pv(scores, v):
    """softmax over the last axis in f32, p rounded to v.dtype before p@v
    (f32 accumulation, output in v.dtype). scores: (B,KV,G,q,s)."""
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(F32),
                        v.to(F32)).to(v.dtype)


def direct_attention(q, k, v, *, n_kv: int, causal: bool = True,
                     window: int | None = None):
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    qg = _group(q, n_kv)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(F32), k.to(F32)) * scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        scores = torch.where(ok, scores, torch.full_like(scores, NEG))
    return _softmax_pv(scores, v).reshape(b, s, h, hd)


def _masked(q, k, v, n_kv: int, chunk: int, window):
    """Chunked causal attention: a loop over q chunks and, inside, over kv
    chunks with the online-softmax update (the reference's `_fwd_masked`
    scan, written as Python loops)."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    g = h // n_kv
    nq = s // chunk
    qg = _group(q, n_kv).to(F32)
    kf, vf = k.to(F32), v
    outs = []
    ar = torch.arange(chunk, device=q.device)
    for qi in range(nq):
        q_blk = qg[:, qi * chunk:(qi + 1) * chunk]
        m = torch.full((b, n_kv, g, chunk), NEG, dtype=F32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n_kv, g, chunk, hd), dtype=F32,
                          device=q.device)
        for kj in range(nq):
            k_blk = kf[:, kj * chunk:(kj + 1) * chunk]
            v_blk = vf[:, kj * chunk:(kj + 1) * chunk]
            qpos = qi * chunk + ar[:, None]
            kpos = kj * chunk + ar[None, :]
            ok = kpos <= qpos
            if window is not None:
                ok &= kpos > qpos - window
            bias = torch.where(ok, 0.0, NEG).to(F32)
            s_blk = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk) * scale
            s_blk = s_blk + bias
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).to(F32),
                              v_blk.to(F32))
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,KV,G,c,hd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, chunk, h, hd)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def pallas_flash_attention(q, k, v, *, causal: bool = True):
    """Model-layout attention through the flash_attention kernel: q (B, S,
    H, hd), k/v (B, S, KV, hd), made dense in the kernel's (B, H, S, hd)
    layout and transposed back. Forward only."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import dense
    o = ops.flash_attention(dense(q.transpose(1, 2)),
                            dense(k.transpose(1, 2)),
                            dense(v.transpose(1, 2)), causal=causal)
    return o.transpose(1, 2)


def attention(q, k, v, *, n_kv: int, causal: bool = True,
              window: int | None = None, chunk: int = 1024,
              schedule: str = "auto"):
    """Prefill attention. q: (B,S,H,hd); k/v: (B,S,KV,hd)."""
    s = q.shape[1]
    if schedule not in ("auto", "direct", "masked", "pallas"):
        raise NotImplementedError(
            f"attention schedule {schedule!r}: the port has direct, masked "
            f"and pallas so far (folded and banded are ROADMAP Queue 1 "
            f"item 3)")
    if schedule == "pallas" and causal and window is None:
        return pallas_flash_attention(q, k, v, causal=True)
    if schedule == "pallas":      # the kernel has no window or full path here
        schedule = "auto"
    if schedule == "auto":
        if s <= 2 * chunk or s % chunk or not causal:
            schedule = "direct"
        else:
            schedule = "masked"
    if schedule == "direct" or not causal:
        return direct_attention(q, k, v, n_kv=n_kv, causal=causal,
                                window=window)
    return _masked(q, k, v, n_kv, chunk, window)


def cross_attention(q, k, v, *, n_kv: int, chunk: int = 1024):
    """Non-causal attention of q (B, S, H, hd) against a short context k/v
    (B, S_kv, KV, hd), kept whole; long q is taken `chunk` rows at a time
    so the (S x S_kv) scores never exist at full S."""
    b, s, h, hd = q.shape
    if s <= 2 * chunk or s % chunk:
        return direct_attention(q, k, v, n_kv=n_kv, causal=False)
    kf = k.to(F32)
    outs = []
    for q0 in range(0, s, chunk):
        qg = _group(q[:, q0:q0 + chunk], n_kv)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(F32), kf) \
            * hd ** -0.5
        outs.append(_softmax_pv(scores, v).reshape(b, chunk, h, hd))
    return torch.cat(outs, dim=1)


def per_slot(pos, b: int, device) -> torch.Tensor:
    """`pos` (an int, a 0-d or a (B,) tensor) as a (B,) tensor. An int is
    filled on the device, not copied from the host: a CUDA graph may be
    capturing, and a capture takes no copy from pageable host memory."""
    if isinstance(pos, numbers.Integral):
        return torch.full((b,), int(pos), dtype=torch.int64, device=device)
    pos = torch.as_tensor(pos, device=device)
    return pos.expand(b) if pos.ndim == 0 else pos


def decode_attention(q, k_cache, v_cache, pos, *, n_kv: int,
                     window: int | None = None, rolling: bool = False):
    """Single-token decode. q: (B,1,H,hd); caches: (B, S_c, KV, hd);
    pos: int or (B,) tensor — the number of tokens already cached."""
    b, sc, kv, hd = k_cache.shape
    h = q.shape[2]
    scale = hd ** -0.5
    qg = _group(q, n_kv)[:, 0]                       # (B, KV, G, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(F32),
                          k_cache.to(F32)) * scale
    idx = torch.arange(sc, device=q.device)
    pos_b = per_slot(pos, b, q.device)
    if rolling:
        ok = idx[None, :] < torch.clamp(pos_b, max=sc)[:, None]
    else:
        ok = idx[None, :] < pos_b[:, None]
        if window is not None:
            ok &= idx[None, :] >= (pos_b[:, None] - window)
    scores = torch.where(ok[:, None, None, :], scores,
                         torch.full_like(scores, NEG))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(F32),
                       v_cache.to(F32)).to(v_cache.dtype)
    return out.reshape(b, 1, h, hd)


def update_cache(k_cache, v_cache, k_new, v_new, pos, *,
                 rolling: bool = False):
    """Write (B, 1, KV, hd) new keys/values at `pos` (int: every slot the
    same row; (B,) tensor: each slot its own row). In place — the
    reference donates these buffers; returns the caches."""
    sc = k_cache.shape[1]
    b = k_new.shape[0]
    pos_b = per_slot(pos, b, k_cache.device)
    slot = pos_b % sc if rolling else pos_b
    rows = torch.arange(b, device=k_cache.device)
    k_cache[rows, slot] = k_new[:, 0]
    v_cache[rows, slot] = v_new[:, 0]
    return k_cache, v_cache


# ----------------------------------------------------------------------------
# Paged KV — runtime/kvpool.py owns the host-side allocator
# ----------------------------------------------------------------------------

def paged_update_cache(k_pool, v_pool, k_new, v_new, pos, pages):
    """Scatter (B, 1, KV, hd) new keys/values through per-slot page tables,
    in place. Pools are (n_pages, page_size, KV, hd); slot b's token lands
    at pool[pages[b, pos_b // page_size], pos_b % page_size]. Retired
    slots' tables point at the trash page 0."""
    ps = k_pool.shape[1]
    b = k_new.shape[0]
    pos_b = per_slot(pos, b, k_pool.device)
    page_idx = torch.gather(pages, 1, (pos_b // ps)[:, None].long())[:, 0]
    off = pos_b % ps
    k_pool[page_idx.long(), off.long()] = k_new[:, 0]
    v_pool[page_idx.long(), off.long()] = v_new[:, 0]
    return k_pool, v_pool


def paged_gather(pool, pages):
    """Each slot's pages as a contiguous (B, npp * ps, KV, hd) view.
    Positions past a slot's written length read stale data or the trash
    page; the decode mask gives them exactly zero weight."""
    b, npp = pages.shape
    _, ps, kv, hd = pool.shape
    return pool[pages.long()].reshape(b, npp * ps, kv, hd)


def paged_decode_attention(q, k_pool, v_pool, pos, pages, *, n_kv: int):
    """`decode_attention` against the shared pool."""
    return decode_attention(q, paged_gather(k_pool, pages),
                            paged_gather(v_pool, pages), pos, n_kv=n_kv)


def copy_page(pool, src, dst):
    """Device page copy (COW fork), in place: pool[dst] = pool[src]."""
    pool[dst] = pool[src]
    return pool


def zero_pages(pool, pages):
    """Scrub the listed pages, in place."""
    pool[torch.as_tensor(pages, device=pool.device).long()] = 0
    return pool

"""Attention for the port (the forward half of `repro.models.attention`).

  direct   — materialise the (S x S) scores; small S.
  masked   — q-chunk x kv-chunk blocks with causal masking and an online
             softmax; the same function as `direct` in bounded memory.
  folded   — exact causal: q chunk i folded with q chunk nq-1-i, so each
             fold scans nq+1 kv blocks and no block above the diagonal
             (an even chunk count, no window shorter than S; else masked).
  banded   — sliding window: each q chunk scans the window/chunk + 1 kv
             blocks of its band (O(S*w) instead of O(S^2)).
  pallas   — the flash_attention kernel (`kernels/flash_attention.py`,
             hand-written CUDA on the GPU) for causal attention without a
             window; anything else falls back to "auto", as the reference
             does.

The chunked schedules are the reference's scans written as Python loops.
They share one flash-style VJP (`FlashFn`, the reference's `_flash`):
the forward saves only (q, k, v, out, lse), and the backward recomputes
each (q chunk, kv chunk) score block. `direct` is plain autograd, as in
the reference. Where the reference's band clips a block index below 0
and masks the duplicate block whole, the port skips it, forward and
backward: a block that masks every key adds exactly nothing (its
probabilities are exp(-1e30 - lse) = 0) once a later block holds a live
key, which the diagonal block always does.

`cross_attention` is non-causal attention against a short context
(whisper's encoder output), chunked over q when q is long.

Decode attention over a private or a paged cache is plain tensor code, as
in the reference. GQA is computed in grouped form throughout. Every
product goes through `layers.product`: scores in f32, p rounded to v's
dtype before p @ v, as the reference rounds.
"""

from __future__ import annotations

import numbers

import torch

from .layers import dense, product

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
    return product("bkgqs,bskd->bqkgd", p.to(v.dtype), v, v.dtype)


def direct_attention(q, k, v, *, n_kv: int, causal: bool = True,
                     window: int | None = None):
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    qg = _group(q, n_kv)
    scores = product("bqkgd,bskd->bkgqs", qg, k, F32) * scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        scores = torch.where(ok, scores, torch.full_like(scores, NEG))
    return _softmax_pv(scores, v).reshape(b, s, h, hd)


def _causal_bias(c: int, qi: int, kj: int, window, device):
    """(c, c) additive f32 bias of q chunk qi against kv chunk kj."""
    ar = torch.arange(c, device=device)
    qpos = qi * c + ar[:, None]
    kpos = kj * c + ar[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG).to(F32)


class _Online:
    """The online-softmax state of one q chunk (the reference's m, l, acc
    and `_block_attn` / `_finish`)."""

    def __init__(self, q_blk, scale: float):
        b, c, kv, g, hd = q_blk.shape
        self.q, self.scale = q_blk, scale
        self.m = torch.full((b, kv, g, c), NEG, dtype=F32,
                            device=q_blk.device)
        self.l = torch.zeros_like(self.m)
        self.acc = torch.zeros((b, kv, g, c, hd), dtype=F32,
                               device=q_blk.device)

    def update(self, k_blk, v_blk, bias) -> None:
        s_blk = product("bqkgd,bskd->bkgqs", self.q, k_blk, F32)
        s_blk = s_blk * self.scale + bias
        m_new = torch.maximum(self.m, s_blk.amax(dim=-1))
        p = torch.exp(s_blk - m_new[..., None])
        alpha = torch.exp(self.m - m_new)
        self.l = self.l * alpha + p.sum(dim=-1)
        pv = product("bkgqs,bskd->bkgqd", p.to(v_blk.dtype), v_blk, F32)
        self.acc = self.acc * alpha[..., None] + pv
        self.m = m_new

    def finish(self, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """-> out (B, c, H, hd) in `dtype`, lse (B, KV, G, c) in f32."""
        l = torch.clamp(self.l, min=1e-30)
        out = self.acc / l[..., None]
        b, kv, g, c, hd = out.shape
        out = out.permute(0, 3, 1, 2, 4).reshape(b, c, kv * g, hd).to(dtype)
        return out, self.m + torch.log(l)


def _chunks(q, k, v, n_kv: int, chunk: int):
    """q grouped and split in q chunks, k/v split in kv chunks."""
    qg = _group(q, n_kv)
    nq = q.shape[1] // chunk
    sl = [slice(i * chunk, (i + 1) * chunk) for i in range(nq)]
    return ([qg[:, x] for x in sl], [k[:, x] for x in sl],
            [v[:, x] for x in sl])


def _joined(finished):
    """[(out, lse)] of the q chunks in order -> out (B, S, H, hd), lse
    (nq, B, KV, G, c)."""
    return (torch.cat([o for o, _ in finished], dim=1),
            torch.stack([lse for _, lse in finished]))


def _masked(q, k, v, n_kv: int, chunk: int, window):
    """Chunked causal attention: every q chunk against every kv chunk with
    the online-softmax update (the reference's `_fwd_masked` scan)."""
    scale = q.shape[-1] ** -0.5
    qc, kc, vc = _chunks(q, k, v, n_kv, chunk)
    outs = []
    for qi, q_blk in enumerate(qc):
        st = _Online(q_blk, scale)
        for kj in range(len(kc)):
            st.update(kc[kj], vc[kj],
                      _causal_bias(chunk, qi, kj, window, q.device))
        outs.append(st.finish(q.dtype))
    return _joined(outs)


def _band(qi: int, nband: int):
    """The kv chunks q chunk qi visits in a band of `nband` blocks: qi -
    nband + 1 .. qi, the clipped duplicates below 0 skipped."""
    return range(max(qi - nband + 1, 0), qi + 1)


def _banded(q, k, v, n_kv: int, chunk: int, window: int):
    """Sliding-window attention (the reference's `_fwd_banded`): q chunk
    qi against the kv chunks qi - nband + 1 .. qi, nband = min(window //
    chunk + 1, nq); band slots below chunk 0 are skipped (see above)."""
    scale = q.shape[-1] ** -0.5
    qc, kc, vc = _chunks(q, k, v, n_kv, chunk)
    nq = len(qc)
    nband = min(window // chunk + 1, nq)
    outs = []
    for qi, q_blk in enumerate(qc):
        st = _Online(q_blk, scale)
        for kj in _band(qi, nband):
            st.update(kc[kj], vc[kj],
                      _causal_bias(chunk, qi, kj, window, q.device))
        outs.append(st.finish(q.dtype))
    return _joined(outs)


def _folded(q, k, v, n_kv: int, chunk: int):
    """Exact causal attention (the reference's `_fwd_folded`): fold f
    pairs q chunk lo = f with hi = nq-1-f and walks t = 0..nq, block t of
    lo while t <= lo, then block t-lo-1 of hi: nq+1 blocks a fold, none
    above the diagonal. nq must be even."""
    scale = q.shape[-1] ** -0.5
    qc, kc, vc = _chunks(q, k, v, n_kv, chunk)
    nq = len(qc)
    outs = [None] * nq
    for f in range(nq // 2):
        lo, hi = f, nq - 1 - f
        st = {lo: _Online(qc[lo], scale), hi: _Online(qc[hi], scale)}
        for t in range(nq + 1):
            qi, kj = (lo, t) if t <= lo else (hi, t - lo - 1)
            st[qi].update(kc[kj], vc[kj],
                          _causal_bias(chunk, qi, kj, None, q.device))
        outs[lo], outs[hi] = st[lo].finish(q.dtype), st[hi].finish(q.dtype)
    return _joined(outs)


def _flash_fwd(q, k, v, n_kv: int, chunk: int, window, schedule: str):
    """(out, lse) of a chunked schedule (the reference's
    `_flash_fwd_inner`)."""
    if schedule == "folded":
        return _folded(q, k, v, n_kv, chunk)
    if schedule == "banded":
        return _banded(q, k, v, n_kv, chunk, window)
    return _masked(q, k, v, n_kv, chunk, window)


def _flash_bwd(q, k, v, out, lse, dout, n_kv: int, chunk: int, window,
               schedule: str):
    """The reference's `_flash_bwd`: for each q chunk, D = rowsum(dout *
    out), then for each kv block of its band the score block recomputed
    from the saved lse; dk / dv accumulate into full-length f32 buffers, dq
    a q chunk at a time. Products and roundings are the reference's."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    qc, kc, vc = _chunks(q, k, v, n_kv, chunk)
    og, dog = _group(out, n_kv), _group(dout, n_kv)
    nq = len(qc)
    nband = (min(window // chunk + 1, nq)
             if window is not None and schedule == "banded" else nq)
    dk = torch.zeros((b, s, n_kv, hd), dtype=F32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for qi, q_blk in enumerate(qc):
        rows = slice(qi * chunk, (qi + 1) * chunk)
        o_blk, do_blk = og[:, rows], dog[:, rows]
        D = torch.einsum("bqkgd,bqkgd->bkgq", do_blk.to(F32), o_blk.to(F32))
        dq = torch.zeros(q_blk.shape, dtype=F32, device=q.device)
        for kj in (_band(qi, nband) if nband < nq else range(nq)):
            k_blk, v_blk = kc[kj], vc[kj]
            s_blk = (product("bqkgd,bskd->bkgqs", q_blk, k_blk, F32) * scale
                     + _causal_bias(chunk, qi, kj, window, q.device))
            p = torch.exp(s_blk - lse[qi][..., None])
            dv_c = product("bkgqs,bqkgd->bskd", p, do_blk.to(F32), F32)
            dp = product("bqkgd,bskd->bkgqs", do_blk, v_blk, F32)
            ds = p * (dp - D[..., None]) * scale
            dq = dq + product("bkgqs,bskd->bqkgd", ds.to(k.dtype), k_blk,
                              F32)
            dk_c = product("bkgqs,bqkgd->bskd", ds, q_blk.to(F32), F32)
            cols = slice(kj * chunk, (kj + 1) * chunk)
            dk[:, cols] += dk_c
            dv[:, cols] += dv_c
        dqs.append(dq)
    dq = torch.cat(dqs, dim=1).reshape(b, s, h, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashFn(torch.autograd.Function):
    """The chunked schedules' flash VJP (the reference's `_flash`
    custom_vjp): forward `_flash_fwd`, residuals (q, k, v, out, lse),
    backward `_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, n_kv, chunk, window, schedule):
        out, lse = _flash_fwd(q, k, v, n_kv, chunk, window, schedule)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan = (n_kv, chunk, window, schedule)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _flash_bwd(*ctx.saved_tensors, dout.contiguous(),
                           *ctx.plan)
        return (*grads, None, None, None, None)


def flash(q, k, v, *, n_kv: int, chunk: int, window, schedule: str):
    """A chunked schedule's output, through `FlashFn` when autograd
    records it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashFn.apply(q, k, v, n_kv, chunk, window, schedule)
    return _flash_fwd(q, k, v, n_kv, chunk, window, schedule)[0]


def pallas_flash_attention(q, k, v, *, causal: bool = True):
    """Model-layout attention through the flash_attention kernel: q (B, S,
    H, hd), k/v (B, S, KV, hd), made dense in the kernel's (B, H, S, hd)
    layout and transposed back. Forward only, as in the reference
    (`ops.flash_attention` raises under grad)."""
    from repro_torch.kernels import ops
    o = ops.flash_attention(dense(q.transpose(1, 2)),
                            dense(k.transpose(1, 2)),
                            dense(v.transpose(1, 2)), causal=causal)
    return o.transpose(1, 2)


SCHEDULES = ("auto", "direct", "masked", "folded", "banded", "pallas")


def resolve_schedule(s: int, *, causal: bool = True,
                     window: int | None = None, chunk: int = 1024,
                     schedule: str = "auto") -> str:
    """The schedule `attention` runs for S = `s`, by the reference's
    rules: "pallas" for causal input without a window (else "auto");
    "auto" takes direct for short, ragged or non-causal input, banded for
    a window shorter than S, else masked; folded needs an even chunk count
    and no such window (else masked); non-causal input is direct."""
    if schedule not in SCHEDULES:
        raise ValueError(f"attention schedule {schedule!r}: expected one "
                         f"of {SCHEDULES}")
    if schedule == "pallas":
        if causal and window is None:
            return "pallas"
        schedule = "auto"         # the kernel has no window or full path
    if schedule == "auto":
        if s <= 2 * chunk or s % chunk or not causal:
            schedule = "direct"
        elif window is not None and window < s:
            schedule = "banded"
        else:
            schedule = "masked"
    if schedule == "folded" and ((s // chunk) % 2
                                 or (window and window < s)):
        schedule = "masked"
    return "direct" if not causal else schedule


def attention(q, k, v, *, n_kv: int, causal: bool = True,
              window: int | None = None, chunk: int = 1024,
              schedule: str = "auto"):
    """Prefill attention. q: (B,S,H,hd); k/v: (B,S,KV,hd); the schedule
    as `resolve_schedule` picks it."""
    schedule = resolve_schedule(q.shape[1], causal=causal, window=window,
                                chunk=chunk, schedule=schedule)
    if schedule == "pallas":
        return pallas_flash_attention(q, k, v, causal=True)
    if schedule == "direct":
        return direct_attention(q, k, v, n_kv=n_kv, causal=causal,
                                window=window)
    return flash(q, k, v, n_kv=n_kv, chunk=chunk, window=window,
                 schedule=schedule)


def cross_attention(q, k, v, *, n_kv: int, chunk: int = 1024):
    """Non-causal attention of q (B, S, H, hd) against a short context k/v
    (B, S_kv, KV, hd), kept whole; long q is taken `chunk` rows at a time
    so the (S x S_kv) scores never exist at full S."""
    b, s, h, hd = q.shape
    if s <= 2 * chunk or s % chunk:
        return direct_attention(q, k, v, n_kv=n_kv, causal=False)
    outs = []
    for q0 in range(0, s, chunk):
        qg = _group(q[:, q0:q0 + chunk], n_kv)
        scores = product("bqkgd,bskd->bkgqs", qg, k, F32) * hd ** -0.5
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
    pos: int or (B,) tensor — the number of tokens already cached.

    The caches are read where they lie. A batch of (slot, kv head) pairs
    cannot step through a (B, S_c, KV, hd) cache with one stride, so the
    grouped product as one batched GEMM would copy the whole cache every
    step. Instead each slot's queries of every kv head meet the keys (and
    the probabilities the values) of every kv head, in one product a slot
    that reads the cache in place, and the kv-head diagonal is kept: the
    same sums, for KV times the multiply-adds of a product bound by the
    cache's bytes."""
    b, sc, kv, hd = k_cache.shape
    h = q.shape[2]
    scale = hd ** -0.5
    qg = _group(q, n_kv)[:, 0]                       # (B, KV, G, hd)
    pairs = product("bkgd,bsjd->bkgsj", qg, k_cache, F32)
    scores = torch.diagonal(pairs, dim1=1, dim2=4).movedim(-1, 1) * scale
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
    pairs = product("bkgs,bsjd->bkgjd", p.to(v_cache.dtype), v_cache,
                    v_cache.dtype)
    out = torch.diagonal(pairs, dim1=1, dim2=3).movedim(-1, 1)
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

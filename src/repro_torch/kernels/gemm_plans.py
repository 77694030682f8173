"""The GEMM kernels' plan knobs as the tuning layer sees them.

Four wrappers (`matmul`, `rmsnorm_matmul`, `matmul_residual_add`,
`matmul_bias_act`) and `flash_attention_proj`'s projection run their
products on three Hopper kernels, each of which picks its own plan from a
count model in C++:

  * the mainloop (`csrc/wgmma_gemm.cuh`, bf16, M > 16, K and N % 8 == 0):
    its N tile, ``tile_n`` in TILE_N (`hopper::pick_bn`);
  * the decode kernel (`csrc/decode_gemm.cuh`, bf16, M <= 16, K and N % 8
    == 0, K <= 32768): ``boxes`` (64-column boxes a column tile) and
    ``cluster`` (CTAs splitting K) (`decode::search`);
  * the 3xTF32 product (`csrc/tf32x3_gemm.cuh`, f32, K and N % 4 == 0):
    ``tile_n`` in {64, 128} and ``cluster`` (`tf32x3::search`).

This module mirrors their constants and their shared-memory arithmetic
(so the tune space holds only plans the kernels take), models each plan's
time for `pipeline.score`, and asks the built library on the card which
plan the kernel picks itself (`own_plan`). Any other shape runs a path
with no plan to pin (split-K, the wmma tile, the CUDA-core f32 tile): its
tune space is the one point ``{}``.
"""

from __future__ import annotations

import ctypes
from typing import Iterator

from repro_torch.core import mesh as hw

from .pipeline import Traffic

# csrc/wgmma_gemm.cuh
BM, BK, BOX = 128, 64, 64
A_BYTES = BM * BK * 2
B_BOX_BYTES = BK * BOX * 2
SMEM_CAP = 220 * 1024
TILE_N = (128, 160, 176, 224, 256)
MAX_CLUSTER = 8
SKINNY_MAX_M = 16
# csrc/decode_gemm.cuh
BOX_K = 64
MAX_BOXES = 8
MIN_STAGES, PAIR_STAGES, SOLO_STAGES = 4, 12, 24
PAIR_SMEM, SOLO_SMEM = 110 * 1024, SMEM_CAP
MAX_K = MAX_CLUSTER * 4096
WAVE_BOXES = 8
# csrc/tf32x3_gemm.cuh
TF32_BK = 32
TF32_TILE_N = (64, 128)
TF32_MAX_STAGES = 6
TF32_TILE_FIXED, TF32_REDUCE_FIXED = 300, 150
FUSED_MAX_M = 2 * BM


def mainloop_smem(bn: int) -> int:
    """`hopper::Tile<BN>::SMEM`: the ring of up to 6 stages of one 128 x 64
    A box and ceil(bn / 64) B boxes, plus 1 KB to align."""
    stage = A_BYTES + (bn + BOX - 1) // BOX * B_BOX_BYTES
    return min(SMEM_CAP // stage, 6) * stage + 1024


def pick_tile_n(m: int, n: int, sms: int = hw.SMS) -> int:
    """`hopper::pick_bn`: the N tile with the least ceil(tiles / SMs) x BN
    (the columns one SM walks), the wider tile on a tie."""
    mt = -(-m // BM)
    best, best_cost = TILE_N[0], None
    for bn in TILE_N:
        cost = -(-(mt * -(-n // bn)) // sms) * bn
        if best_cost is None or cost <= best_cost:
            best, best_cost = bn, cost
    return best


def decode_smem(m: int, boxes: int, kboxes: int, stages: int) -> int:
    """`decode::smem_bytes`."""
    mpad = 16 if m > 8 else 8
    return (1024 + stages * B_BOX_BYTES + (mpad + 1) * (kboxes * BOX_K + 8)
            * 2 + (boxes * 8 + MAX_CLUSTER) * 8 * mpad * 4)


def decode_fit(m: int, boxes: int, kboxes: int) -> tuple[int, int] | None:
    """`decode::fit`'s (CTAs an SM, shared memory), or None."""
    fixed = decode_smem(m, boxes, kboxes, 0)
    room = MIN_STAGES * B_BOX_BYTES
    if fixed + room <= PAIR_SMEM:
        per_sm, cap, top = 2, PAIR_SMEM, PAIR_STAGES
    elif fixed + room <= SOLO_SMEM:
        per_sm, cap, top = 1, SOLO_SMEM, SOLO_STAGES
    else:
        return None
    stages = min((cap - fixed) // B_BOX_BYTES, top)
    return per_sm, decode_smem(m, boxes, kboxes, stages)


def tf32_fit(m: int, k: int, bn: int, c: int) -> int | None:
    """`tf32x3::fit`'s shared memory, or None."""
    kb = -(-k // TF32_BK)
    kper = -(-kb // c)
    stage = BM * TF32_BK * 4 + (3 if m <= FUSED_MAX_M else 2) * bn \
        * TF32_BK * 4
    recv = 0 if c <= 1 else c * -(-(bn // 8) // c) * BM * 8 * 4
    fixed = 1024 + recv
    if fixed + stage > SMEM_CAP:
        return None
    stages = min((SMEM_CAP - fixed) // stage, TF32_MAX_STAGES)
    if c > 1:
        stages = min(stages, kper)
    if stages < min(kper, 2):
        return None
    return fixed + stages * stage


def route(m: int, k: int, n: int, dtype_bytes: int) -> str:
    """Which kernel runs an (M, K) x (K, N) product: "mainloop",
    "decode", "tf32x3" or "fixed" (a path with no plan knob)."""
    if dtype_bytes == 2 and k % 8 == 0 and n % 8 == 0:
        if m > SKINNY_MAX_M:
            return "mainloop"
        if 0 < m and k <= MAX_K:
            return "decode"
    if dtype_bytes == 4 and k % 4 == 0 and n % 4 == 0:
        return "tf32x3"
    return "fixed"


def space(m: int, k: int, n: int, dtype_bytes: int,
          kind: str | None = None) -> Iterator[dict]:
    """The plans the kernel of `kind` (default: `route`'s) takes at this
    shape."""
    r = kind or route(m, k, n, dtype_bytes)
    if r == "mainloop":
        for bn in TILE_N:
            yield {"tile_n": bn}
    elif r == "decode":
        kbox = -(-k // BOX_K)
        for c in range(1, MAX_CLUSTER + 1):
            kbc = -(-kbox // c)
            if (c - 1) * kbc >= kbox:
                continue
            for b in range(1, MAX_BOXES + 1):
                if decode_fit(m, b, kbc) is None:
                    break
                yield {"boxes": b, "cluster": c}
    elif r == "tf32x3":
        kb = -(-k // TF32_BK)
        for bn in TF32_TILE_N:
            for c in range(1, MAX_CLUSTER + 1):
                kper = -(-kb // c)
                if (c - 1) * kper >= kb or bn // 8 < c:
                    continue
                if tf32_fit(m, k, bn, c) is not None:
                    yield {"tile_n": bn, "cluster": c}
    else:
        yield {}


def _model_pick(m: int, k: int, n: int, dtype_bytes: int, r: str) -> dict:
    """The model's own pick: `pick_bn` on the mainloop, the least modeled
    time over the space on the decode and 3xTF32 kernels."""
    if r == "mainloop":
        return {"tile_n": pick_tile_n(m, n)}
    if r == "fixed":
        return {}
    best, best_s = {}, None
    for cand in space(m, k, n, dtype_bytes, r):
        t = traffic(m, k, n, dtype_bytes, cand, kind=r)
        s = max(t.flops / t.peak_flops, t.hbm_bytes / hw.HBM_BW) \
            * t.quantization + t.fixed_s
        if best_s is None or s < best_s:
            best, best_s = cand, s
    return best


def traffic(m: int, k: int, n: int, dtype_bytes: int, knobs: dict,
            extra_bytes: float = 0.0, extra_flops: float = 0.0,
            kind: str | None = None) -> Traffic:
    """The product's work under `knobs` (``{}``: the kernel's own pick) on
    the kernel of `kind` (default: `route`'s), with the busiest SM's share
    of it as each kernel's own search counts it. `extra_bytes` /
    `extra_flops`: a fused op's prologue and epilogue."""
    r = kind or route(m, k, n, dtype_bytes)
    if not knobs and r != "fixed":
        knobs = _model_pick(m, k, n, dtype_bytes, r)
    ideal = float((m * k + k * n + m * n) * dtype_bytes) + extra_bytes
    flops = 2.0 * m * n * k + extra_flops
    sms = hw.SMS
    if r == "mainloop":
        bn = knobs["tile_n"]
        tiles = -(-m // BM) * -(-n // bn)
        waves = -(-tiles // sms)
        return Traffic(flops=flops, hbm_bytes=ideal, ideal_bytes=ideal,
                       grid_steps=tiles, smem_bytes=mainloop_smem(bn),
                       quantization=waves * sms * BM * bn / max(m * n, 1))
    if r == "decode":
        b, c = knobs["boxes"], knobs["cluster"]
        kbox = -(-k // BOX_K)
        kbc = -(-kbox // c)
        per_sm, smem = decode_fit(m, b, kbc) or (1, SOLO_SMEM + 1)
        tiles = -(-n // (b * BOX))
        wave = max(per_sm * sms // c, 1)
        waves = -(-tiles // wave)
        box_s = B_BOX_BYTES * per_sm * sms / hw.HBM_BW
        return Traffic(flops=flops, hbm_bytes=ideal, ideal_bytes=ideal,
                       grid_steps=tiles * c, smem_bytes=smem,
                       quantization=waves * wave / tiles,
                       fixed_s=waves * WAVE_BOXES * box_s)
    if r == "tf32x3":
        bn, c = knobs["tile_n"], knobs["cluster"]
        kb = -(-k // TF32_BK)
        kper = -(-kb // c)
        tiles = -(-m // BM) * -(-n // bn)
        conc = sms if c == 1 else sms // c
        waves = -(-tiles // conc)
        unit_s = BM * TF32_BK * 2 * 3 * sms / hw.PEAK_FLOPS_TF32
        fixed = waves * (TF32_TILE_FIXED
                         + (TF32_REDUCE_FIXED + bn // 2 if c > 1 else 0))
        smem = tf32_fit(m, k, bn, c)
        return Traffic(flops=3 * flops, hbm_bytes=ideal, ideal_bytes=ideal,
                       grid_steps=tiles * c,
                       smem_bytes=smem if smem is not None else SMEM_CAP + 1,
                       peak_flops=hw.PEAK_FLOPS_TF32,
                       quantization=waves * kper * sms / (tiles * kb),
                       fixed_s=fixed * unit_s)
    peak = hw.PEAK_FLOPS_BF16 if dtype_bytes == 2 else hw.PEAK_FLOPS_F32
    return Traffic(flops=flops, hbm_bytes=ideal, ideal_bytes=ideal,
                   grid_steps=-(-m // 64) * -(-n // 128), smem_bytes=0,
                   peak_flops=peak)


# ----------------------------------------------------------------------------
# the kernel's own pick, from the built library (on the card)
# ----------------------------------------------------------------------------

def wgmma_plan(lib: str, m: int, n: int, tile_n: int = 0) -> tuple:
    """`wgmma_plan` of library `lib`: (N tile, tiles, blocks)."""
    from . import build
    p = (ctypes.c_int * 3)()
    build.check(lib, build.entry(lib, "wgmma_plan")(m, n, tile_n, p))
    return tuple(p)


def decode_plan(lib: str, m: int, k: int, n: int, boxes: int = 0,
                cluster: int = 0) -> tuple:
    """`<lib>_decode_plan`: (N tile, cluster, CTAs, k a CTA, stages)."""
    from . import build
    p = (ctypes.c_int * 5)()
    build.check(lib, build.entry(lib, f"{lib}_decode_plan")(
        m, n, k, boxes, cluster, p))
    return tuple(p)


def f32_plan(m: int, k: int, n: int, tile_n: int = 0,
             cluster: int = 0) -> tuple:
    """`matmul_f32_plan`: (route, N tile, cluster, tiles, blocks, k a
    block, stages)."""
    from . import build
    p = (ctypes.c_int * 7)()
    build.check("matmul", build.entry("matmul", "matmul_f32_plan")(
        m, n, k, tile_n, cluster, p))
    return tuple(p)


def own_plan(lib: str, m: int, k: int, n: int, dtype_bytes: int) -> dict:
    """The knobs the kernel of library `lib` picks itself at this shape."""
    r = route(m, k, n, dtype_bytes)
    if r == "mainloop":
        return {"tile_n": wgmma_plan(lib, m, n)[0]}
    if r == "decode":
        bn, c = decode_plan(lib, m, k, n)[:2]
        return {"boxes": bn // BOX, "cluster": c}
    if r == "tf32x3":
        p = f32_plan(m, k, n)
        return {"tile_n": p[1], "cluster": p[2]}
    return {}

"""The tuning layer — each kernel's plan measured, not modeled.

The port's counterpart of the autotuner half of `repro.kernels.pipeline`
(the other half, `KernelPipeline` / `TileSpec` / the fusion hooks, emits
`pl.pallas_call` and has no counterpart: each Hopper kernel is written by
hand in `csrc/`). Every kernel describes its tune space in a `KernelDef`,
registered beside its wrapper (`kernels/{matmul,fused,...}.py`):

  * the *knobs* are the Hopper kernel's own plan knobs, named apart from
    the reference's Pallas blocking (``bm`` / ``bn`` / ``bk`` ...): the
    mainloop's N tile ``tile_n`` (`csrc/wgmma_gemm.cuh` TILE_N), the decode
    kernel's ``boxes`` (64-column boxes a column tile) and ``cluster``
    (`csrc/decode_gemm.cuh`), the 3xTF32 product's ``tile_n`` and
    ``cluster`` (`csrc/tf32x3_gemm.cuh`); a kernel whose plan is fixed at
    compile time has the one-point space ``{}``;
  * the default lane is ``{}``: the kernel's own pick. On the card the
    race names it concretely (`KernelDef.own_plan`: `wgmma_plan`,
    `<name>_decode_plan`, `matmul_f32_plan`), so lanes that name the same
    plan are timed once;
  * `traffic(shapes, knobs, dtype_bytes)` is pure shape math, and `score`
    a Hopper roofline over `core/mesh.py` with the wave quantisation the
    kernels' own plan searches count. A candidate whose shared memory does
    not fit a block's 227 KB is dropped (the reference's VMEM budget).
    There is no MemPool Top_H locality factor on the card: `locality` is
    1.0, since the Top_H model (`core/interconnect.py`) describes
    MemPool's L1 banks, not the card's memory, and the race measures the
    card.

`autotune` ranks the candidates by `score` and, under the "timed" tune
mode, races the top `REPRO_TUNE_TOPN` (default 3) plus the default — and,
for a fused op, its unfused composition (`ops.OPS[name].composition`) —
on synthetic operands, keeping the measured winner in
`configs.registry.KERNEL_TUNES` and writing it through to the active
`kernels.tunedb.TuneDB`. On CUDA operands a lane is timed with CUDA events
with the L2 flushed before each rep (the knobs change device time, and
the decode kernel streams its weights); on the CPU by the wall clock.
"""

from __future__ import annotations

import dataclasses
import math
import os
import statistics
import time
from typing import Any, Callable, Iterator, Sequence

import torch

from repro_torch.core import mesh as hw
from repro_torch.device import resolve_device

# ----------------------------------------------------------------------------
# Traffic / cost model
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Traffic:
    """The work of one kernel invocation under one plan.

    `saved_bytes` is set on fused kernels only: the intermediate's write
    and read the unfused composition would stream. `smem_bytes` is the
    shared memory a block of the plan takes; `quantization` (>= 1) is the
    busiest SM's share of the work over an even spread across the card
    (the wave quantisation `hopper::pick_bn` and the decode and 3xTF32
    plan searches count); `fixed_s` is the plan's fixed time (a wave's
    launch and reduction); `peak_flops` is the rate of the operation's
    operand type (`core/mesh.PEAKS`).
    """

    flops: float
    hbm_bytes: float
    ideal_bytes: float
    grid_steps: int
    smem_bytes: int
    transcendentals: float = 0.0
    saved_bytes: float = 0.0
    peak_flops: float = hw.PEAK_FLOPS_BF16
    quantization: float = 1.0
    fixed_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    compute_s: float
    memory_s: float
    overhead_s: float
    locality: float
    p_local: float
    total_s: float


def score(traffic: Traffic) -> CostBreakdown:
    """Modeled seconds of one invocation: the roofline's compute and
    memory terms overlapped, scaled by the plan's wave quantisation, plus
    its fixed time. `locality` stays 1.0: the Top_H model describes
    MemPool's L1 banks, not the card's memory."""
    from repro_torch.launch.roofline import kernel_roofline

    r = kernel_roofline(traffic.flops, traffic.hbm_bytes, traffic.peak_flops)
    q = max(traffic.quantization, 1.0)
    compute_s, memory_s = r["compute_s"] * q, r["memory_s"] * q
    p_local = min(1.0, traffic.ideal_bytes / max(traffic.hbm_bytes, 1.0))
    return CostBreakdown(compute_s=compute_s, memory_s=memory_s,
                         overhead_s=traffic.fixed_s, locality=1.0,
                         p_local=p_local,
                         total_s=max(compute_s, memory_s) + traffic.fixed_s)


# ----------------------------------------------------------------------------
# Kernel registry
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelDef:
    """A kernel's contract with the tuning layer.

    `traffic(shapes, knobs, dtype_bytes)` and `tune_space(shapes,
    dtype_bytes)` are pure shape math; `default_blocks(shapes)` is the
    default lane, ``{}`` (the kernel's own pick). `own_plan(shapes,
    dtype_bytes)`, when given, asks the built kernel on the card which
    knobs its own pick names (None: the kernel has no knob)."""

    name: str
    traffic: Callable[[dict, dict, int], Traffic]
    tune_space: Callable[[dict, int], Iterator[dict]]
    default_blocks: Callable[[dict], dict] = lambda shapes: {}
    own_plan: Callable[[dict, int], dict] | None = None


KERNELS: dict[str, KernelDef] = {}


def register(defn: KernelDef) -> KernelDef:
    KERNELS[defn.name] = defn
    return defn


def one_point(shapes: dict, dtype_bytes: int = 4) -> Iterator[dict]:
    """The tune space of a kernel with no plan knob: its own plan."""
    yield {}


def shape_key(shapes: dict, dtype_bytes: int = 4) -> str:
    # dtype_bytes is part of the key: f32 and bf16 operands run different
    # kernels (`matmul`: the 3xTF32 product against the bf16 mainloop)
    return f"b{dtype_bytes}_" + "_".join(
        f"{k}{shapes[k]}" for k in sorted(shapes))


def block_candidates(dim: int, *, align: int = 8, cap: int = 8,
                     max_block: int | None = None) -> list[int]:
    """Divisors of `dim` that are multiples of `align`, geometrically
    thinned; [dim] when nothing aligns."""
    cands = [d for d in range(align, dim + 1, align) if dim % d == 0]
    if not cands:
        cands = [dim]
    if max_block is not None:
        capped = [c for c in cands if c <= max_block]
        cands = capped or [min(cands)]
    if len(cands) > cap:
        idx = sorted({round(i * (len(cands) - 1) / (cap - 1))
                      for i in range(cap)})
        cands = [cands[i] for i in idx]
    return cands


def snap_block(dim: int, block: int) -> int:
    """Largest divisor of `dim` that is <= `block` (>= 1)."""
    block = max(1, min(block, dim))
    while dim % block:
        block -= 1
    return block


def resolve_block(dim: int, block: int | None, default: int) -> int:
    """The reference's check of a Pallas block against its dimension:
    None snaps `default`; an explicit value is capped at the dimension and
    must then divide it."""
    if block is None:
        return snap_block(dim, default)
    block = max(1, min(block, dim))
    if dim % block:
        raise ValueError(
            f"block size {block} does not divide dimension {dim}; pass a "
            f"divisor or omit it for the snapped default")
    return block


def knob_names(kernel: str, shapes: dict, dtype_bytes: int) -> set[str]:
    """The Hopper knobs `kernel` takes at these shapes."""
    return {k for b in KERNELS[kernel].tune_space(shapes, dtype_bytes)
            for k in b}


def check_knobs(kernel: str, shapes: dict, dtype_bytes: int,
                knobs: dict) -> None:
    """Raise unless `knobs` (Hopper knobs only) name a plan of the
    kernel's tune space at these shapes (a partial pin may leave the other
    knob to the kernel's search)."""
    if not knobs:
        return
    for cand in KERNELS[kernel].tune_space(shapes, dtype_bytes):
        if all(cand.get(k) == v for k, v in knobs.items()):
            return
    raise ValueError(
        f"{kernel}: {knobs} is no plan of its tune space at {shapes} "
        f"(dtype bytes {dtype_bytes}); knobs there: "
        f"{sorted(knob_names(kernel, shapes, dtype_bytes)) or 'none'}")


# ----------------------------------------------------------------------------
# Autotuner
# ----------------------------------------------------------------------------

SMEM_BUDGET_BYTES = hw.SMEM_PER_BLOCK


@dataclasses.dataclass(frozen=True)
class TuneResult:
    kernel: str
    shapes: tuple[tuple[str, int], ...]
    blocks: dict[str, int]
    cost: CostBreakdown
    default_blocks: dict[str, int]
    default_cost: CostBreakdown
    measured_us: float = 0.0
    default_us: float = 0.0
    source: str = "modeled"
    raced: int = 0                  # lanes actually timed (incl. default)
    route: str = "fused"

    @property
    def timed(self) -> bool:
        return self.measured_us > 0.0

    @property
    def measured_speedup(self) -> float:
        if not self.timed:
            return 1.0
        return self.default_us / max(self.measured_us, 1e-30)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


_FLUSH: dict[int, torch.Tensor] = {}

# a spin kernel of ~1 ms (clock cycles) queued before each timed rep: the
# host has that long to queue the launch before the card reaches the start
# event, so a host that is descheduled (its cores shared) does not add its
# pause to the kernel's time (tools/tune_timing.py --stress measures both)
SPIN_CYCLES = 2_000_000


def _l2_flush(device: torch.device) -> torch.Tensor:
    """A buffer of 5x the 50 MB L2, zeroed before each timed rep."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _FLUSH:
        _FLUSH[idx] = torch.empty(5 * hw.L2_BYTES, dtype=torch.uint8,
                                  device=device)
    return _FLUSH[idx]


def median_time(fn: Callable[[], Any], *, reps: int = 3, warmup: int = 1,
                device=None) -> float:
    """Median seconds per call of `fn()` after `warmup` discarded runs.
    On a CUDA `device` each rep is timed with CUDA events after a spin of
    `SPIN_CYCLES` and the L2 flushed; otherwise by the wall clock."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        for _ in range(max(warmup, 0)):
            fn()
        times = []
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
    flush = _l2_flush(dev)
    for _ in range(max(warmup, 0)):
        fn()
    times = []
    for _ in range(max(reps, 1)):
        if SPIN_CYCLES:
            torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e-3)
    return statistics.median(times)


@dataclasses.dataclass(frozen=True)
class _RaceOutcome:
    blocks: dict[str, int]
    measured_s: float
    default_s: float
    lanes: int
    route: str = "fused"
    default_blocks: dict = dataclasses.field(default_factory=dict)


# sentinel "blocks" dict the composition lane hands the injectable timer —
# tests key on it to force the unfused route to win or lose a race
COMPOSITION_LANE = {"route": "unfused"}

_RACE_DTYPES = {2: torch.bfloat16, 8: torch.float64}


def _race(kernel: str, shapes: dict, candidates: Sequence[dict],
          default_blocks: dict, dtype_bytes: int, *,
          timer: Callable[[Callable, dict], float] | None = None,
          reps: int | None = None, warmup: int | None = None,
          device=None) -> _RaceOutcome | None:
    """Time each candidate plan (plus the default and, for a fused op, its
    composition) on synthetic operands on `device`; the measured winner,
    or None when racing is impossible (no operand factory, operands that
    cannot be made, every lane failed).

    On a CUDA device the default lane is named by the kernel's own plan
    (`KernelDef.own_plan`) and lanes naming the same plan are timed once.
    `timer(fn, blocks) -> seconds` is injectable for deterministic tests.
    """
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    if dev.type == "meta":
        raise RuntimeError(
            f"autotune({kernel!r}): a race times the kernel and cannot run "
            f"on meta tensors (a dry run's trace takes the tune record or "
            f"the kernel's own plan)")
    desc = ops.OPS.get(kernel)
    if desc is None or desc.operands is None:
        return None
    try:
        operands = desc.operands(shapes, _RACE_DTYPES.get(
            dtype_bytes, torch.float32), dev)
    except Exception:
        return None
    defn = KERNELS.get(kernel)
    default = dict(default_blocks)
    if dev.type == "cuda" and defn is not None and defn.own_plan is not None:
        default = dict(defn.own_plan(shapes, dtype_bytes))
    if timer is None:
        reps = _env_int("REPRO_TUNE_REPS", 3) if reps is None else reps
        warmup = 1 if warmup is None else warmup

        def timer(fn, blocks, _r=reps, _w=warmup):
            return median_time(fn, reps=_r, warmup=_w, device=dev)

    lanes: list[dict] = []
    seen: set = set()
    for b in (*candidates, default):
        k = tuple(sorted(b.items()))
        if k not in seen:
            seen.add(k)
            lanes.append(dict(b))
    times: list[float] = []
    for b in lanes:
        try:
            times.append(float(timer(lambda b=b: desc.wrapper(*operands, **b),
                                     b)))
        except Exception:
            times.append(float("inf"))      # a lane that won't run can't win
    best = min(range(len(lanes)), key=times.__getitem__)
    if not math.isfinite(times[best]):
        return None
    default_key = tuple(sorted(default.items()))
    default_s = next(t for b, t in zip(lanes, times)
                     if tuple(sorted(b.items())) == default_key)
    comp_s, comp_lanes = float("inf"), 0
    if desc.composition is not None:
        comp_lanes = 1
        try:
            comp_s = float(timer(lambda: desc.composition(*operands),
                                 dict(COMPOSITION_LANE)))
        except Exception:
            comp_s = float("inf")
    if comp_s < times[best]:
        return _RaceOutcome(blocks=lanes[best], measured_s=comp_s,
                            default_s=default_s,
                            lanes=len(lanes) + comp_lanes, route="unfused",
                            default_blocks=default)
    return _RaceOutcome(blocks=lanes[best], measured_s=times[best],
                        default_s=default_s, lanes=len(lanes) + comp_lanes,
                        default_blocks=default)


# the last autotune result of each (kernel, shape_key): the lanes raced and
# both modeled costs, which a record does not keep (reports read it)
TUNE_RESULTS: dict[tuple[str, str], TuneResult] = {}


def backend_of(device) -> str:
    """The TuneDB backend key of a device: "cuda" for a CUDA device,
    "torch_cpu" for the port on the CPU — never the reference's "cpu",
    "gpu" or "tpu", so a DB both packages share never hands Pallas blocks
    to a Hopper kernel, or the other way round."""
    dev = torch.device("cuda" if device is None else device)
    return "cuda" if dev.type == "cuda" else "torch_cpu"


def autotune(kernel: str, shapes: dict, *, dtype_bytes: int = 4,
             smem_budget: int = SMEM_BUDGET_BYTES,
             register_record: bool = True,
             mode: str | None = None,
             timer: Callable[[Callable, dict], float] | None = None,
             top_n: int | None = None,
             reps: int | None = None,
             device=None) -> TuneResult:
    """Pick the measured-fastest plan for `kernel` at `shapes`.

    Every candidate of the kernel's tune space that fits `smem_budget` is
    ranked by `score`. Under the "timed" tune mode (`tunedb.tune_mode`)
    the top `top_n` (REPRO_TUNE_TOPN, default 3) and the default lane are
    raced on `device` (the card unless given) and the measured winner is
    kept; "modeled" keeps the score-only pick, "frozen" too and never
    writes the DB. The winner is registered in `KERNEL_TUNES` under
    (kernel, shape_key) and, when timed, written through to the active
    TuneDB under `backend_of(device)`. A race bumps the ambient
    KernelPolicy's `tune_races`.
    """
    from repro_torch.cluster.policy import current_policy
    from repro_torch.kernels import tunedb

    defn = KERNELS[kernel]
    scored: list[tuple[float, dict]] = []
    for blocks in defn.tune_space(shapes, dtype_bytes):
        t = defn.traffic(shapes, blocks, dtype_bytes)
        if t.smem_bytes > smem_budget:
            continue
        scored.append((score(t).total_s, dict(blocks)))
    if not scored:                 # the budget excluded all: the first one
        blocks = next(iter(defn.tune_space(shapes, dtype_bytes)))
        scored = [(score(defn.traffic(shapes, blocks, dtype_bytes)).total_s,
                   dict(blocks))]
    scored.sort(key=lambda sc: sc[0])
    best_blocks = dict(scored[0][1])
    default = dict(defn.default_blocks(shapes))
    default_cost = score(defn.traffic(shapes, default, dtype_bytes))

    resolved = tunedb.tune_mode(mode)
    measured_us = default_us = 0.0
    source, raced, route = "modeled", 0, "fused"
    if resolved == "timed":
        top_n = _env_int("REPRO_TUNE_TOPN", 3) if top_n is None else top_n
        outcome = _race(kernel, shapes,
                        [b for _, b in scored[:max(top_n, 1)]], default,
                        dtype_bytes, timer=timer, reps=reps, device=device)
        if outcome is not None:
            best_blocks = dict(outcome.blocks)
            default = dict(outcome.default_blocks)
            default_cost = score(defn.traffic(shapes, default, dtype_bytes))
            measured_us = outcome.measured_s * 1e6
            default_us = outcome.default_s * 1e6
            source, raced, route = "timed", outcome.lanes, outcome.route
            current_policy().bump("tune_races")

    best_traffic = defn.traffic(shapes, best_blocks, dtype_bytes)
    best_cost = score(best_traffic)
    result = TuneResult(kernel=kernel,
                        shapes=tuple(sorted(shapes.items())),
                        blocks=best_blocks, cost=best_cost,
                        default_blocks=dict(default),
                        default_cost=default_cost,
                        measured_us=measured_us, default_us=default_us,
                        source=source, raced=raced, route=route)
    TUNE_RESULTS[(kernel, shape_key(shapes, dtype_bytes))] = result
    if register_record:
        from repro_torch.configs import registry
        rec = registry.register_kernel_tune(registry.KernelTuneRecord(
            kernel=kernel, shape_key=shape_key(shapes, dtype_bytes),
            blocks=tuple(sorted(best_blocks.items())),
            modeled_seconds=best_cost.total_s,
            default_blocks=tuple(sorted(default.items())),
            default_modeled_seconds=default_cost.total_s,
            saved_bytes=best_traffic.saved_bytes,
            measured_us=measured_us, default_us=default_us, source=source,
            route=route))
        if source == "timed" and resolved != "frozen":
            db = tunedb.active_db()
            if db is not None:
                db.record(rec, backend=backend_of(device),
                          mode=current_policy().mode)
    return result


def tuned_record(kernel: str, shapes: dict, *, dtype_bytes: int = 4,
                 **autotune_kwargs):
    """Registry-first tune record for (kernel, shapes, dtype): a hit
    (a TuneDB warm start included) returns without racing, a miss runs
    `autotune`. Bumps the ambient policy's tune_hits / tune_misses."""
    from repro_torch.cluster.policy import current_policy
    from repro_torch.configs import registry
    key = shape_key(shapes, dtype_bytes)
    rec = registry.get_kernel_tune(kernel, key)
    if rec is not None:
        current_policy().bump("tune_hits")
        return rec
    current_policy().bump("tune_misses")
    autotune(kernel, shapes, dtype_bytes=dtype_bytes, **autotune_kwargs)
    return registry.get_kernel_tune(kernel, key)


def tuned_blocks(kernel: str, shapes: dict, *, dtype_bytes: int = 4,
                 **autotune_kwargs) -> dict:
    """Registry-cached tuned knobs for (kernel, shapes, dtype); tunes on
    a miss."""
    return dict(tuned_record(kernel, shapes, dtype_bytes=dtype_bytes,
                             **autotune_kwargs).blocks)


# every kernel module registers its KernelDef beside its wrapper
from . import (axpy, conv2d, dct8x8, dotp, flash_attention,  # noqa: E402,F401
               fused, matmul, rmsnorm)

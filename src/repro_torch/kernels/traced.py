"""The kernels on meta operands: what a dry run's trace of the card's
route records in place of a launch (`device.tracing_card`,
`core/op_cost.py`).

A wrapper given meta operands inside `tracing_card()` checks its
operands as it does on the card, makes its result and its workspace as
meta tensors (both count in the trace's peak) and calls `record`: one
entry of each open ledger (`ledger()`), under the name of the route the
card would take (`route`: the Hopper mainloop, the decode kernel at M <=
16, 3xTF32 for f32), with `pipeline.KERNELS[name].traffic(shapes, {},
dtype_bytes)`'s flops, HBM bytes and transcendentals. Nothing is built
or launched, and the wrapper's `launches` count is left alone: a record
is not a launch.

`workspace_floats(name, *sizes)` is each library's
`<name>_workspace_floats` in Python (chip_smoke's [dryrun] phase holds
the two equal at the traced shapes). `count_plain` is each plain
version's count: its calls with CUDA operands in ``<plain>.cuda_calls``,
and those with meta operands inside `tracing_card()` in `PLAIN_CALLS`,
which a trace of the card's route keeps at 0.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
from typing import Iterator

import torch

from repro_torch.core import mesh as hw
from repro_torch.device import tracing

from . import gemm_plans, pipeline

# the plain versions run on meta operands inside tracing_card(), by name
PLAIN_CALLS: collections.Counter = collections.Counter()
_LEDGERS: list[list] = []


@dataclasses.dataclass(frozen=True)
class KernelRecord:
    """One kernel call of a trace: the wrapper, the route the card takes
    at these shapes, and the kernel's modeled work."""
    name: str
    route: str
    shapes: tuple
    flops: float
    hbm_bytes: float
    transcendentals: float
    workspace_bytes: int
    workspace_sizes: tuple | None = None   # `<name>_workspace_floats`'s


@contextlib.contextmanager
def ledger() -> Iterator[list]:
    """A list that every `record` made inside the block is appended to."""
    records: list = []
    _LEDGERS.append(records)
    try:
        yield records
    finally:
        _LEDGERS.remove(records)


def count_plain(fn, x: torch.Tensor) -> None:
    """Count a call of plain version `fn` on the card's route."""
    if x.is_cuda:
        fn.cuda_calls += 1
    elif x.is_meta and tracing():
        PLAIN_CALLS[fn.__name__] += 1


def route(name: str, shapes: dict, dtype_bytes: int) -> str:
    """The route kernel `name` takes on the card at `shapes`."""
    if name in ("rmsnorm", "flash_attention"):
        return name
    if name == "flash_attention_proj":
        return "attention+mainloop"
    m, k, n = shapes["m"], shapes["k"], shapes["n"]
    r = gemm_plans.route(m, k, n, dtype_bytes)
    if r != "fixed":
        return r
    if dtype_bytes == 4:
        return "sgemm"
    return "split_k" if m <= gemm_plans.SKINNY_MAX_M else "wmma_tile"


def _split_k_floats(m: int, n: int, k: int, sms: int) -> int:
    """`split_k_workspace_floats` (csrc/common.cuh, `skinny::plan`)."""
    if m > gemm_plans.SKINNY_MAX_M or m <= 0 or n <= 0 or k <= 0:
        return 0
    tiles = -(-n // 256) * -(-m // 8)
    slots = 2 * sms
    max_s = k // 64 if k // 64 > 1 else 1
    best, best_fill = 1, -1.0
    for waves in (1, 2):
        s = max(1, min(waves * slots // tiles, max_s))
        blocks = s * tiles
        fill = blocks / (-(-blocks // slots) * slots)
        if fill > best_fill + 1e-9:
            best, best_fill = s, fill
    per = -(-k // best)
    per = -(-per // 8) * 8
    return -(-k // per) * m * n


def _decode_floats(m: int, n: int, k: int, sms: int) -> int:
    """`decode_workspace_floats` (csrc/decode_gemm.cuh)."""
    if gemm_plans.route(m, k, n, 2) == "decode":
        return 0
    return _split_k_floats(m, n, k, sms)


def workspace_floats(name: str, *sizes: int) -> int:
    """The f32 floats `<name>_workspace_floats(*sizes)` returns, for the
    kernels whose wrapper allocates a workspace (the library's argument
    order). The split-K plan reads the card's SM count (an H100's
    without a card)."""
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if torch.cuda.is_available() else hw.SMS)
    if name == "flash_attention_proj":
        b, h, s, dm = sizes
        if min(sizes) <= 0:
            return 0
        return (b * s * h * 128 + 1) // 2
    if name == "matmul":
        m, n, k, f32 = sizes
        if f32:
            if min(m, n, k) <= 0 or n % 4 or k % 4:
                return 0
            return 0 if m <= gemm_plans.FUSED_MAX_M else 2 * n * k
        return _decode_floats(m, n, k, sms)
    m, n, k = sizes
    if name == "rmsnorm_matmul" and m > 0 and k > 0 and \
            gemm_plans.route(m, k, n, 2) == "mainloop":
        return (m * k + 1) // 2
    if name in ("rmsnorm_matmul", "matmul_residual_add", "matmul_bias_act"):
        return _decode_floats(m, n, k, sms)
    raise KeyError(f"{name}: its wrapper allocates no workspace")


@functools.lru_cache(maxsize=4096)
def _traffic(name: str, shapes: tuple, dtype_bytes: int):
    return pipeline.KERNELS[name].traffic(dict(shapes), {}, dtype_bytes)


def record(name: str, shapes: dict, dtype: torch.dtype, device,
           workspace: tuple | None = None) -> None:
    """Record one call of kernel `name` at `shapes` in every open ledger,
    making its workspace (the sizes `<name>_workspace_floats` takes; one
    float when it needs none, as `build.workspace` allocates) as a meta
    tensor on `device` for the call's span."""
    ws = None
    if workspace is not None:
        floats = workspace_floats(name, *workspace)
        ws = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    db = dtype.itemsize
    key = tuple(sorted(shapes.items()))
    t = _traffic(name, key, db)
    rec = KernelRecord(name, route(name, shapes, db), key, float(t.flops),
                       float(t.hbm_bytes), float(t.transcendentals),
                       0 if ws is None else ws.numel() * 4, workspace)
    for records in _LEDGERS:
        records.append(rec)
    del ws

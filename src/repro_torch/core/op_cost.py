"""Op costs of a traced cell — the port's counterpart of
`repro.core.hlo_cost` (which walks XLA's compiled text).

A dry run runs one rank's cell on meta tensors (`cluster/session.py`
`CompiledDryRun`), and `tracked()` counts what that run issues, op by
op:

  flops           — the products by `FlopCounterMode`'s formulas and
                    rule (mm / bmm and their f32-result overloads,
                    convolutions, attention), plus
                    an element a pointwise op's result and an element a
                    reduction's input, plus the kernel records' flops;
  transcendentals — an element a result of exp, log, tanh, rsqrt, ... ;
  bytes           — each non-view aten op's inputs and outputs (the
                    reference's unfused-op rule, `hlo_cost.py:400-420`:
                    on the card every eager op is a kernel that reads its
                    inputs from HBM and writes its outputs there), plus the
                    kernel records' HBM bytes and the collectives' results;
  collectives     — `core/collectives.py`'s calls, each with its group's
                    size, priced by `core/locality._op_bytes`.

The hand-written kernels are not aten ops: inside `tracing_card()` their
wrappers record each call (`kernels/traced.py`), with the flops and
bytes of their `pipeline.KernelDef` traffic. `FlopCounterMode`'s count
alone does not see them, which makes it the counterpart of XLA's
built-in cost analysis, which does not see loops
(`cost_analysis_builtin`). The counter applies its formulas itself
rather than stacking the mode: one dispatch layer a op, not two.

The tracker also follows the live bytes of the run's storages (an
argument registered before the run, every op's outputs as they are
made, each freed when its last tensor dies) for `locality.
extract_memory`.

The reference's `while_report` does not apply: the port's layer and
microbatch loops are Python loops, and each iteration is counted as it
runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Iterator

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, shape_wrapper

from repro_torch.core import collectives
from repro_torch.kernels import traced

aten = torch.ops.aten

TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
                  "tanh", "sigmoid", "rsqrt", "sqrt", "sin", "cos", "tan",
                  "erf", "erfc", "erfinv", "silu", "gelu", "softplus",
                  "pow", "reciprocal", "_softmax", "_log_softmax",
                  "logsumexp"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
              "argmin", "prod", "cumsum", "cumprod", "var", "std",
              "var_mean", "norm", "linalg_vector_norm", "any", "all",
              "_softmax", "_log_softmax", "logsumexp", "topk", "sort"}
# ops that make no bytes move: allocators, aliases, metadata
FREE = {"empty", "empty_strided", "empty_like", "new_empty",
        "new_empty_strided", "empty_permuted", "detach", "alias",
        "lift_fresh", "_unsafe_view", "set_", "resize_", "is_same_size",
        "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
        "sym_storage_offset"}
# the collectives' own ops: priced from `collectives.ledger()` instead
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _mm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """mm / bmm, the f32-result overloads (`out_dtype=`) included, which
    torch's own formulas take the dtype of as their output shape."""
    return 2 * math.prod(a_shape) * b_shape[-1]


# `FlopCounterMode`'s formulas (products, convolutions, attention), by
# op packet
FLOPS = {**flop_registry, aten.mm: shape_wrapper(_mm_flop),
         aten.bmm: shape_wrapper(_mm_flop)}
# the metadata queries `FlopCounterMode` leaves to the tensor
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format,
             aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default,
             aten.sym_stride.default, aten.storage_offset.default,
             aten.sym_storage_offset.default, aten.numel.default,
             aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LiveBytes:
    """The bytes of the live storages this tracker has seen, and their
    peak: a storage counts once (its views share it) from when it is
    seen until its last tensor dies."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._seen: set[int] = set()

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        if key in self._seen:
            self._seen.discard(key)
            self.live -= n

    def close(self) -> None:
        """Stop following: later frees no longer change the counts."""
        self._seen.clear()


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (nested lists and
    tuples), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _key(x):
    """A hashable key of an op's argument: a tensor by its metadata."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(map(_key, x))
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in sorted(x.items()))
    return x


_UNCACHED = object()


class OpCounter(TorchDispatchMode):
    """Counts each aten op's products (`FlopCounterMode`'s formulas and
    its rule: an op with a decomposition is counted as its pieces),
    elementwise flops, transcendentals and bytes, and hands its outputs
    to a `LiveBytes`.

    On meta tensors an op's result depends on its arguments' metadata
    alone, so a new-result op (not a view, not in place) seen before with
    the same metadata makes its results from the first call's shapes,
    strides and dtypes instead of running its meta function again: a
    trace repeats the same ops layer after layer and block after block."""

    def __init__(self, live: LiveBytes):
        super().__init__()
        self.live = live
        self.products = 0           # FlopCounterMode's count
        self.flops = 0.0            # the elementwise ops' and reductions'
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.ops = 0
        self._results: dict = {}

    def _call(self, func, args, kwargs):
        if func.is_view or func._schema.is_mutable:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
            hit = self._results.get(key)
        except TypeError:                    # an unhashable argument
            return func(*args, **kwargs)
        if hit is _UNCACHED:
            return func(*args, **kwargs)
        if hit is not None:
            made = [None if m is None else torch.empty_strided(
                m[0], m[1], dtype=m[2], device="meta") for m in hit[1]]
            return made[0] if hit[0] else tuple(made)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        results = [out] if single else out
        ins = {t.untyped_storage()._cdata
               for t in _tensors((args, kwargs), [])}
        if (not isinstance(results, (tuple, list)) or not all(
                r is None or (isinstance(r, torch.Tensor) and r.is_meta
                              and r.untyped_storage()._cdata not in ins)
                for r in results) or any(
                t.device.type != "meta" for t in _tensors((args, kwargs),
                                                          []))):
            self._results[key] = _UNCACHED
            return out
        self._results[key] = (single, [
            None if r is None else (tuple(r.shape), r.stride(), r.dtype)
            for r in results])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        ns, _, name = func._schema.name.partition("::")
        if ns in COLLECTIVE_NAMESPACES:
            return func(*args, **kwargs)
        out = self._call(func, args, kwargs)
        formula = FLOPS.get(func._overloadpacket)
        if formula is not None:
            self.products += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out, [])
        for t in outs:
            self.live.add(t)
        if func.is_view or name in FREE:
            return out
        ins = _tensors((args, kwargs), [])
        self.ops += 1
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        base = name.rstrip("_") if not name.startswith("_") else name
        n_out = sum(t.numel() for t in outs)
        if base in TRANSCENDENTAL:
            n = ins[0].numel() if base in REDUCTIONS and ins else n_out
            self.flops += n
            self.transcendentals += n
        elif base in REDUCTIONS:
            self.flops += ins[0].numel() if ins else 0
        elif torch.Tag.pointwise in func.tags:
            self.flops += n_out
        return out


@dataclasses.dataclass
class Tracker:
    """What `tracked()` counted: the op counter, the kernel records, the
    collective calls and the live bytes, with the cell's arguments and
    outputs (`arguments` / `outputs`)."""
    ops: OpCounter
    kernels: list
    calls: list
    live: LiveBytes
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0               # outputs in donated arguments
    output_argument_bytes: int = 0     # outputs in other arguments
    _arguments: set = dataclasses.field(default_factory=set)
    _donated: set = dataclasses.field(default_factory=set)

    def arguments(self, args, donate=()) -> None:
        """Register the cell's arguments (made before the trace) as live,
        the storages of the positions in `donate` as donated."""
        for i, a in enumerate(args):
            for t in pytree.tree_leaves(a):
                if not isinstance(t, torch.Tensor):
                    continue
                key = t.untyped_storage()._cdata
                if i in donate:
                    self._donated.add(key)
                if key not in self._arguments:
                    self._arguments.add(key)
                    self.argument_bytes += t.untyped_storage().nbytes()
                self.live.add(t)

    def outputs(self, out) -> None:
        """Register the cell's result: its storages' bytes, those of them
        that are donated arguments' (updated in place) as aliased."""
        seen: set[int] = set()
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            self.output_bytes += st.nbytes()
            if st._cdata in self._donated:
                self.alias_bytes += st.nbytes()
            elif st._cdata in self._arguments:
                self.output_argument_bytes += st.nbytes()

    @property
    def peak_bytes(self) -> int:
        return self.live.peak


@contextlib.contextmanager
def tracked() -> Iterator[Tracker]:
    """Count everything the block runs (see the module docstring)."""
    live = LiveBytes()
    with traced.ledger() as kernels, collectives.ledger() as calls:
        ops = OpCounter(live)
        tracker = Tracker(ops, kernels, calls, live)
        try:
            with ops:
                yield tracker
        finally:
            live.close()


def analyze(tracker: Tracker) -> dict:
    """`hlo_cost.analyze`'s keys from a trace: flops, transcendentals,
    bytes, the collectives' operand and wire bytes, and each kind's
    count, operand bytes and wire bytes."""
    from repro_torch.core import locality

    report = locality.report(tracker.calls)
    flops = (float(tracker.ops.products) + tracker.ops.flops + sum(k.flops for k in tracker.kernels))
    trans = tracker.ops.transcendentals + sum(k.transcendentals
                                              for k in tracker.kernels)
    byts = (tracker.ops.bytes + sum(k.hbm_bytes for k in tracker.kernels)
            + sum(c.result_bytes for c in tracker.calls))
    return {"flops": flops, "transcendentals": trans, "bytes": byts,
            "collective_operand_bytes": report.operand_bytes,
            "collective_wire_bytes": report.wire_bytes,
            "collectives": {k: {"count": v.count,
                                "operand_bytes": v.operand_bytes,
                                "wire_bytes": v.wire_bytes}
                            for k, v in sorted(report.by_kind.items())}}

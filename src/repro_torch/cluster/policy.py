"""KernelPolicy — which implementation of each kernel op runs.

The port's counterpart of `repro.cluster.policy`:

  KernelPolicy(mode="tuned" | "fused" | "reference" | "interpret",
               overrides={op_name: mode_or_blocks},
               tuning="auto" | "timed" | "modeled" | "frozen")

* ``tuned``     — the hand-written Hopper kernel for a CUDA tensor (the
                  plain PyTorch version for a CPU tensor). The default.
                  The model stack takes the plain (unfused) route.
* ``fused``     — the same kernels, and the model stack takes the fused
                  producer-consumer route (`models/blocks.py`), which is
                  where the three fused kernels sit.
* ``reference`` — the plain oracles of `kernels/ref.py`.
* ``interpret`` — the plain PyTorch version of the kernel (the port has
                  no interpreter: the plain version repeats the kernel's
                  arithmetic, which is what the Pallas interpreter is for
                  in the reference).

``overrides`` refines single ops: a mode string re-routes that op only
(``{"matmul": "reference"}``), a dict pins its plan for ``tuned_call``:
the Hopper kernel's knobs (``{"matmul": {"tile_n": 128}}``; see
`kernels/pipeline.py`), checked against the op's tune space at the call's
shapes, and the reference's Pallas block names (``bm`` / ``bn`` / ``bk``,
``block_rows``, ``block_n``, ``bq``), checked as the reference checks
them and passed to no kernel. ``tuning`` steers autotune-on-miss, as in
the reference (`kernels.tunedb.tune_mode`).

The active policy is an explicitly scoped stack: ``with use_policy(p):``.
Model code reads ``current_policy()`` when it runs.
``REPRO_KERNEL_POLICY`` picks the default mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Iterator, Mapping

MODES = ("tuned", "fused", "reference", "interpret")
TUNINGS = ("auto", "timed", "modeled", "frozen")


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Kernel-selection policy: a global mode plus per-op overrides.

    ``tuning`` steers how autotune-on-miss picks a plan: ``"timed"`` races
    the top modeled candidates plus the kernel's own plan on the device
    and keeps the measured winner (written through to the active TuneDB);
    ``"modeled"`` keeps the score-only pick; ``"frozen"`` does the same
    and never writes the DB; ``"auto"`` (the default) defers to
    ``REPRO_TUNE_MODE`` (itself defaulting to ``timed``).

    ``stats`` is a mutable per-instance counter dict (``ref_calls``,
    ``plain_calls``, ``kernel_calls``, ``tune_hits``, ``tune_misses``,
    ``tune_races``, ``block_overrides``, ``unfused_routes``) filled in by
    the dispatch sites — excluded from equality.
    """

    mode: str = "tuned"
    overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    tuning: str = "auto"
    stats: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown policy mode {self.mode!r}; "
                             f"expected one of {MODES}")
        if self.tuning not in TUNINGS:
            raise ValueError(f"unknown tuning {self.tuning!r}; "
                             f"expected one of {TUNINGS}")
        for op, v in self.overrides.items():
            if isinstance(v, str):
                if v not in MODES:
                    raise ValueError(f"override for {op!r}: unknown mode "
                                     f"{v!r}; expected one of {MODES}")
            elif not isinstance(v, Mapping):
                raise TypeError(f"override for {op!r} must be a mode string "
                                f"or a block dict, got {type(v).__name__}")

    # -- per-op resolution ----------------------------------------------------
    def mode_for(self, op: str) -> str:
        """The mode governing `op`: its string override, else the global."""
        o = self.overrides.get(op)
        return o if isinstance(o, str) else self.mode

    def blocks_for(self, op: str) -> dict | None:
        """Pinned plan for `op` (a dict override), or None to autotune."""
        o = self.overrides.get(op)
        return dict(o) if isinstance(o, Mapping) else None

    def interpret_for(self, op: str, device=None) -> bool:
        """Does `op` run its plain PyTorch version? Forced by the
        ``interpret`` mode; always for operands off the card (`device`
        given and not CUDA), as the wrappers route CPU tensors."""
        if self.mode_for(op) == "interpret":
            return True
        if device is None:
            return False
        import torch
        return torch.device(device).type != "cuda"

    @property
    def fused(self) -> bool:
        """Does the model stack take the fused producer-consumer route?"""
        return self.mode == "fused"

    # -- dispatch (the tuned_call body) ---------------------------------------
    def call(self, name: str, *operands, **kwargs):
        """Run kernel `name` under this policy: reference short-circuit, a
        pinned plan, or the tuned (registry-cached, tune-on-miss) plan,
        which may be the op's unfused composition. `ops.tuned_call`
        delegates here.

        A miss races on synthetic operands on the operands' device; inside
        a CUDA-graph capture that cannot run, so a miss there raises (a
        hit is a dict lookup and a launch, and capture-safe)."""
        import torch

        from repro_torch.configs import registry
        from repro_torch.kernels import ops, pipeline

        desc = ops.OPS[name]
        if self.mode_for(name) == "reference":
            self.bump("ref_calls")
            return desc.reference(*operands, **kwargs)
        lead = operands[desc.streamed_operand]
        blocks = self.blocks_for(name)
        if blocks is None:
            shapes = desc.shapes(*operands)
            dtype_bytes = lead.dtype.itemsize
            key = pipeline.shape_key(shapes, dtype_bytes)
            rec = registry.get_kernel_tune(name, key)
            if rec is None:
                if lead.is_cuda and torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        f"tuned_call({name!r}): no tune record for {key} "
                        f"inside a CUDA-graph capture; a miss races the "
                        f"kernel on the card, which a capture cannot hold. "
                        f"Tune it (or warm-start a TuneDB) before capturing")
                # miss -> autotune: under "timed" tuning this races the
                # top modeled plans on synthetic operands and keeps the
                # measured winner, bumping tune_races and writing the DB
                self.bump("tune_misses")
                tune = pipeline.autotune(
                    name, shapes, dtype_bytes=dtype_bytes,
                    mode=None if self.tuning == "auto" else self.tuning,
                    device=lead.device)
                blocks, route = dict(tune.blocks), tune.route
            else:
                self.bump("tune_hits")
                blocks, route = dict(rec.blocks), rec.route
            if route == "unfused" and desc.composition is not None:
                # the race demoted this fusion on these shapes: run its
                # composition of primitive kernels instead
                self.bump("unfused_routes")
                return desc.composition(*operands, **kwargs)
        else:
            knobs = {k: v for k, v in blocks.items()
                     if k not in ops.REFERENCE_BLOCKS.get(name, ())}
            pipeline.check_knobs(name, desc.shapes(*operands),
                                 lead.dtype.itemsize, knobs)
            self.bump("block_overrides")
        return desc.wrapper(*operands, **blocks, **kwargs)

    def bump(self, key: str) -> None:
        self.stats[key] = self.stats.get(key, 0) + 1

    def describe(self) -> dict:
        """JSON-able snapshot: knobs + traffic counters (for program
        reports and compile-cache fingerprints)."""
        return {
            "mode": self.mode,
            "overrides": {k: (v if isinstance(v, str) else dict(v))
                          for k, v in sorted(self.overrides.items())},
            "tuning": self.tuning,
            "stats": dict(self.stats),
        }

    def fingerprint(self) -> str:
        """Stable key component (knobs only — stats excluded)."""
        d = self.describe()
        d.pop("stats")
        return repr(sorted((k, repr(v)) for k, v in d.items()))


_STACK: list[KernelPolicy] = []


def default_policy() -> KernelPolicy:
    mode = os.environ.get("REPRO_KERNEL_POLICY", "").strip() or "tuned"
    return KernelPolicy(mode=mode)


def current_policy() -> KernelPolicy:
    return _STACK[-1] if _STACK else default_policy()


def as_policy(p: "KernelPolicy | str | None") -> KernelPolicy:
    """A KernelPolicy, a bare mode string, or None (the default policy)."""
    if isinstance(p, KernelPolicy):
        return p
    if p is None:
        return default_policy()
    if isinstance(p, str):
        return KernelPolicy(mode=p)
    raise TypeError(f"cannot make a KernelPolicy from {type(p).__name__}")


@contextlib.contextmanager
def use_policy(p: "KernelPolicy | str | None") -> Iterator[KernelPolicy]:
    """Scope `p` as the active policy (nests; innermost wins)."""
    pol = as_policy(p)
    _STACK.append(pol)
    try:
        yield pol
    finally:
        _STACK.pop()


@contextlib.contextmanager
def scoped(p: "KernelPolicy | str | None") -> Iterator[KernelPolicy]:
    """Like use_policy, but None inherits the ambient policy."""
    if p is None:
        yield current_policy()
    else:
        with use_policy(p) as pol:
            yield pol

"""KernelPolicy — which implementation of each kernel op runs.

The port's counterpart of `repro.cluster.policy`:

  KernelPolicy(mode="tuned" | "fused" | "reference" | "interpret",
               overrides={op_name: mode})

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

``overrides`` re-routes single ops with a mode string. Block-dict
overrides, ``tuning`` and ``tuned_call`` belong to the tuning layer, which
a later slice ports.

The active policy is an explicitly scoped stack: ``with use_policy(p):``.
Model code reads ``current_policy()`` when it runs.
``REPRO_KERNEL_POLICY`` picks the default mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, Mapping

MODES = ("tuned", "fused", "reference", "interpret")


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Kernel-selection policy: a global mode plus per-op mode overrides.

    ``stats`` is a mutable per-instance counter dict (``ref_calls``,
    ``plain_calls``, ``kernel_calls``) filled in by the dispatch sites in
    `kernels/ops.py` — excluded from equality.
    """

    mode: str = "tuned"
    overrides: Mapping[str, str] = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown policy mode {self.mode!r}; "
                             f"expected one of {MODES}")
        for op, v in self.overrides.items():
            if not isinstance(v, str):
                raise NotImplementedError(
                    f"override for {op!r}: block overrides belong to the "
                    f"tuning layer (ROADMAP Queue 1 item 12)")
            if v not in MODES:
                raise ValueError(f"override for {op!r}: unknown mode "
                                 f"{v!r}; expected one of {MODES}")

    def mode_for(self, op: str) -> str:
        """The mode governing `op`: its override, else the global mode."""
        return self.overrides.get(op, self.mode)

    @property
    def fused(self) -> bool:
        """Does the model stack take the fused producer-consumer route?"""
        return self.mode == "fused"

    def bump(self, key: str) -> None:
        self.stats[key] = self.stats.get(key, 0) + 1

    def describe(self) -> dict:
        """JSON-able snapshot: knobs + traffic counters (for program
        reports and compile-cache fingerprints)."""
        return {
            "mode": self.mode,
            "overrides": dict(sorted(self.overrides.items())),
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

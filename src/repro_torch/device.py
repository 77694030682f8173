"""The port's one device rule, shared by every entry point that allocates:
no device means the GPU, and a missing GPU raises. The port never quietly
runs on the CPU; callers (the tests) ask for it with ``device="cpu"``.

`on_card(t)` is the one predicate of the branches that choose the
arithmetic (the kernel wrappers, the tensor-core products): a CUDA
tensor, or a meta tensor inside `tracing_card()`, the dry run's trace of
the card's route (`core/op_cost.py`), where the wrappers record their
launches instead of making them. Outside that scope a meta tensor takes
the plain route, as a CPU tensor does."""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch

_TRACING = 0                     # depth of the open tracing_card() scopes


@contextlib.contextmanager
def tracing_card() -> Iterator[None]:
    """Inside it, meta tensors take the card's route (`on_card`): a
    dry run traces the kernels, the bf16 tensor-core products and the
    collectives the card would run, and computes nothing."""
    global _TRACING
    _TRACING += 1
    try:
        yield
    finally:
        _TRACING -= 1


def tracing() -> bool:
    """Is a `tracing_card()` scope open?"""
    return _TRACING > 0


def on_card(t: torch.Tensor) -> bool:
    """Does `t` take the card's route: a CUDA tensor, or a meta tensor
    inside `tracing_card()`?"""
    return t.is_cuda or (_TRACING > 0 and t.is_meta)


def resolve_device(device=None) -> torch.device:
    """None -> "cuda". A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; repro_torch runs on the "
                           "GPU unless the caller passes device='cpu'")
    return dev


def canonical_device(dev):
    """`dev` as a value to compare devices by: a CUDA device without an
    index is the current one (``cuda`` and ``cuda:0`` are one card).
    Anything that is not a device or a device string passes through (test
    doubles name their devices as they like)."""
    if isinstance(dev, str) and dev.split(":")[0] in ("cuda", "cpu"):
        dev = torch.device(dev)
    if isinstance(dev, torch.device) and dev.type == "cuda" \
            and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def distinct_devices(devices: Sequence) -> int:
    """How many different devices `devices` names, compared by value."""
    return len(set(canonical_device(d) for d in devices))

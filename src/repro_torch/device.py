"""The port's one device rule, shared by every entry point that allocates:
no device means the GPU, and a missing GPU raises. The port never quietly
runs on the CPU; callers (the tests) ask for it with ``device="cpu"``."""

from __future__ import annotations

from typing import Sequence

import torch


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

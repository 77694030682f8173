"""The port's one device rule, shared by every entry point that allocates:
no device means the GPU, and a missing GPU raises. The port never quietly
runs on the CPU; callers (the tests) ask for it with ``device="cpu"``."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> "cuda". A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; repro_torch runs on the "
                           "GPU unless the caller passes device='cpu'")
    return dev

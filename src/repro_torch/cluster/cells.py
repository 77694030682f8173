"""Serving groups' devices (the port of `repro.cluster.cells.group_devices`).

The rest of the reference module assembles XLA program cells for the
dry-run (`batch_logical`, `shardings_for`, `layer_gather_specs`,
`build_cell`): it is ROADMAP Queue 1 K, with the mesh and the addressing
plan it reads.
"""

from __future__ import annotations

import torch

from repro_torch.device import canonical_device, resolve_device


def cuda_devices() -> list:
    """Every CUDA device this process sees, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def group_devices(devices_or_cluster, n_groups: int) -> tuple:
    """The device each serving group's parameters and state live on
    (tiles -> groups).

    Takes a sequence of devices, a `Cluster` (on a CUDA cluster every card
    this process sees, the cluster's own first; on a CPU cluster its
    device), or None (every CUDA card; raises without CUDA). With fewer
    devices than groups the assignment wraps round-robin: groups share a
    device (degraded but functional: the scheduling is unchanged, only
    the compute overlap is lost), which is what a one-card run hits.
    Devices compare by value (`canonical_device`)."""
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    if devices_or_cluster is None:
        resolve_device(None)            # no CUDA: the port's one error
        devs = cuda_devices()
    elif hasattr(devices_or_cluster, "device"):
        own = canonical_device(devices_or_cluster.device)
        devs = [own]
        if isinstance(own, torch.device) and own.type == "cuda":
            devs += [d for d in cuda_devices() if d != own]
    else:
        devs = [canonical_device(d) for d in devices_or_cluster]
    if not devs:
        raise ValueError("group_devices: no devices to place groups on")
    return tuple(devs[g % len(devs)] for g in range(n_groups))

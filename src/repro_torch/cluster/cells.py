"""Program-cell helpers (the port of `repro.cluster.cells`): the batch's
logical axes, the shardings of a tree of shapes, one super-block's
gather specs, the model FLOPs of a cell, and the serving groups' devices.

The reference's `build_cell` assembles an XLA program cell for its dry
run; it waits with the dry run (ROADMAP Queue 1 K2).
"""

from __future__ import annotations

import torch

from repro_torch.core import addressing
from repro_torch.device import canonical_device, resolve_device


def batch_logical(cfg, shape) -> dict:
    """The logical axes of each input of a workload (`input_specs`)."""
    log = {"tokens": ("batch", "seq")}
    if shape.kind == "train":
        log["labels"] = ("batch", "seq")
    if shape.kind == "decode":
        log["tokens"] = ("batch", None)
        log["pos"] = ()
    if cfg.family == "encdec":
        log["enc_embeds"] = ("batch", None, None)
    if cfg.family == "vlm":
        log["img_embeds"] = ("batch", None, None)
    return log


def shardings_for(tree_sds, tree_logical, mesh, rules):
    """A tree of `addressing.Sharding`s (the mesh and each leaf's spec)
    for a tree of shape records and its logical axes."""
    return addressing.plan_tree(tree_sds, tree_logical, mesh, rules)


def layer_gather_specs(cfg, mesh, rules):
    """The specs of one super-block's weights with the `data` axis left
    out (the FSDP weights gathered for the layer's use), its leading
    stacked "layers" dim stripped. (`rules` is the caller's; the gather
    specs are the default rules without fsdp, as in the reference.)"""
    from repro_torch.models import steps
    gather_rules = addressing.default_rules(mesh, fsdp=False,
                                            overrides=cfg.rules_overrides)
    p_sds, p_log = steps.abstract_params(cfg)
    return addressing.map_trees(
        lambda sds, logical: gather_rules.spec_for(logical[1:],
                                                   sds.shape[1:], mesh),
        p_sds["blocks"], p_log["blocks"])


def model_flops(cfg, shape) -> dict:
    """MODEL_FLOPS of a cell: 6 N D a train step, 2 N D a prefill or a
    decode step (N the active parameters, D the tokens)."""
    n = cfg.n_params()
    n_act = cfg.n_active_params()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        mf = 6.0 * n_act * d
    elif shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        mf = 2.0 * n_act * d
    else:
        d = shape.global_batch
        mf = 2.0 * n_act * d
    return {"n_params": n, "n_active_params": n_act, "tokens": d,
            "model_flops": mf}


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

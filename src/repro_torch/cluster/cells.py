"""Program cells (the port of `repro.cluster.cells`): `build_cell`, the
batch's logical axes, the shardings of a tree of shapes, one
super-block's gather specs, the model FLOPs of a cell, and the serving
groups' devices.

`build_cell` builds the reference's five kinds of cell (train, prefill,
decode, the K-step decode chunk, the slot-scheduled session with or
without the paged pool) over a live (data, model) or (pod, data, model)
process group. Where the reference returns a program for XLA to lower
with its arguments' global shapes and shardings, the port returns what
this rank runs: its callable, its arguments' local shapes (its blocks as
the plan places them) and their placements (the plan's spec on the
mesh), and the donated positions. It lowers nothing: a dry run
(`cluster/session.py` `CompiledDryRun`) traces this rank's cell on meta
tensors (`meta_args`) over a fake process group of the mesh's size, and
counts its flops, bytes, collectives and peak memory.
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import TensorSpec
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
    specs are the default rules without fsdp, as in the reference.) The
    port's per-layer gather (`build_cell(fsdp_gather=True)`) gives each
    layer's leaves these specs' local shapes
    (`tests/test_torch_dp.py`)."""
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


def _local(shards, sds):
    """The local `TensorSpec`s of a tree of shape records and its
    `LeafShard`s."""
    if isinstance(sds, TensorSpec):
        return TensorSpec(shards.local_shape(sds.shape), sds.dtype)
    if isinstance(sds, dict):
        return {k: _local(shards[k], v) for k, v in sds.items()}
    return [_local(sh, v) for sh, v in zip(shards, sds)]


def _placed(mesh, rules, sds, logical):
    """(local `TensorSpec`s, `addressing.Sharding`s) of a tree of global
    shape records and their logical axes: each leaf's block of this rank
    (a dim split over axes of sizes n1 x n2 ... cut by their product)."""
    spec = addressing.spec_tree(sds, logical, mesh, rules)
    local = addressing.map_trees(
        lambda s, sp: TensorSpec(addressing.shard_shape(sp, s.shape, mesh),
                                 s.dtype), sds, spec)
    return local, addressing.plan_tree(sds, logical, mesh, rules)


def build_cell(cfg, shape, mesh, rules, fsdp_gather: bool = False,
               policy=None, decode_chunk: int = 1, session: bool = False,
               max_prompt: int = 8, paged: bool = False,
               page_size: int = 16):
    """-> (fn, args, in_shardings, out_shardings, donate) of this rank on
    `mesh` (a live DeviceMesh over an initialised process group), the
    reference's signature and kinds:

    * train: `steps.make_sharded_train_step`, over (state, batch); with
      `fsdp_gather` its per-layer gather (each decoder layer's leaves
      split over the batch axes gathered as the layer runs, their
      gradients reduce-scattered as backward finishes the layer: the
      reference's gather to `layer_gather_specs` inside its scan);
    * prefill: `steps.make_sharded_prefill_step`, over (params, batch) ->
      this rank's greedy tokens;
    * decode: `steps.make_sharded_decode_step` over (params, cache,
      batch); with `decode_chunk` K > 1 the K-step chunk
      (`engine.decode_chunk_fn`) over (params, cache, tok, finished,
      emitted, pos, remaining); with `session` the slot-scheduled session
      cell (`engine.session_chunk_fn`, K = decode_chunk) over (params,
      state), `paged` putting the pageable K/V in the pool with
      `page_size`-token pages and the state holding the page tables.

    `args` are `TensorSpec`s of this rank's blocks (the parameters in the
    port's per-layer layout, its rows of the batch and of the slot state,
    its blocks of the cache: `steps.state_shards`, `steps.cache_shards`),
    `in_shardings` / `out_shardings` the plan's `addressing.Sharding` of
    each (whole leaves' specs); `donate` the positions updated in place.
    The slot fields, prompt buffers and page tables are split over the
    batch axes as the reference splits them and whole over "model". `fn`
    also carries `.shards` (the parameters' `LeafShard`s) and, in the
    decode kinds, `.cache_shards` and `.sharded_step` (the sharded decode
    step).
    Every cell on a mesh runs eagerly. The serving kinds take
    `fsdp_gather` and ignore it, as the reference's do."""
    from repro_torch.configs import input_specs
    from repro_torch.models import steps
    from repro_torch.runtime import engine

    B, S = shape.global_batch, shape.seq_len
    batch_sds = input_specs(cfg, shape)
    batch_local, batch_sh = _placed(mesh, rules, batch_sds,
                                    batch_logical(cfg, shape))
    slot_sh = addressing.Sharding(mesh, rules.spec_for(("batch",), (B,),
                                                       mesh))
    row_sh = lambda n: addressing.Sharding(
        mesh, rules.spec_for(("batch", None), (B, n), mesh))
    scalar_sh = addressing.Sharding(mesh, ())

    if shape.kind == "train":
        fn = steps.make_sharded_train_step(cfg, mesh, rules=rules,
                                           policy=policy, max_seq=S,
                                           fsdp_gather=fsdp_gather)
        p_sds = _port_specs(cfg, S)
        m_sds = _moment_specs(cfg, p_sds)
        local = _local(fn.shards, {"params": p_sds, "opt": {
            "m": m_sds, "v": m_sds, "step": TensorSpec((), torch.int32)}})
        state_sh = _port_shardings(cfg, mesh, rules, S)
        state_sh = {"params": state_sh, "opt": {
            "m": state_sh, "v": state_sh, "step": scalar_sh}}
        return (fn, (local, batch_local), (state_sh, batch_sh),
                (state_sh, None), (0,))

    params_sh = _port_shardings(cfg, mesh, rules, S)
    if shape.kind == "prefill":
        fn = steps.make_sharded_prefill_step(cfg, mesh, rules=rules,
                                             policy=policy, max_seq=S,
                                             batch=B)
        params = _local(fn.shards, _port_specs(cfg, S))
        return (fn, (params, batch_local), (params_sh, batch_sh), slot_sh,
                ())

    cache_len = steps.decode_cache_len(cfg, S)
    step = steps.make_sharded_decode_step(cfg, mesh, S, rules=rules,
                                          policy=policy, batch=B)
    params = _local(step.shards, _port_specs(cfg, S))
    pps = n_pages = None
    if session and paged:
        pps = -((S + 1) // -page_size)                  # ceil
        n_pages = B * pps + 1
        cache_sds, cache_log = steps.abstract_paged_cache(
            cfg, B, cache_len, n_pages=n_pages, page_size=page_size)
    else:
        cache_sds, cache_log = steps.abstract_cache(cfg, B, cache_len)
    cache_shards = steps.cache_shards(cfg, mesh, rules, B, cache_len,
                                      n_pages=n_pages, page_size=page_size)
    cache = _local(cache_shards, cache_sds)
    cache_sh = shardings_for(cache_sds, cache_log, mesh, rules)

    if session:
        fn = engine.session_chunk_fn(step, decode_chunk, cuda_graph=False,
                                     group=step.group)
        i64, b_loc = torch.int64, slot_sh.shard_shape((B,))[0]
        state = {"cache": cache, **{
            k: TensorSpec((b_loc,) if n is None else (b_loc, n),
                          torch.bool if k in ("finished", "active") else i64)
            for k, n in (("tok", 1), ("pos", None), ("consumed", None),
                         ("prompt_len", None), ("prompt_buf", max_prompt),
                         ("budget", None), ("emitted", None),
                         ("finished", None), ("active", None),
                         ("age", None))}}
        if paged:
            state["pages"] = TensorSpec((b_loc, pps), i64)
        state_sh = {k: (cache_sh if k == "cache" else
                        row_sh(1) if k == "tok" else
                        row_sh(max_prompt) if k == "prompt_buf" else
                        row_sh(pps) if k == "pages" else slot_sh)
                    for k in state}
        out_sh = (state_sh, row_sh(decode_chunk), row_sh(decode_chunk),
                  slot_sh, scalar_sh)
        _attach(fn, step, cache_shards)
        return fn, (params, state), (params_sh, state_sh), out_sh, (1,)
    if decode_chunk > 1:
        fn = engine.decode_chunk_fn(step, decode_chunk)
        i64 = torch.int64
        b_loc = slot_sh.shard_shape((B,))[0]
        args = (params, cache, TensorSpec((b_loc, 1), i64),
                TensorSpec((b_loc,), torch.bool), TensorSpec((b_loc,), i64),
                TensorSpec((), i64), TensorSpec((), i64))
        in_sh = (params_sh, cache_sh, row_sh(1), slot_sh, slot_sh,
                 scalar_sh, scalar_sh)
        out_sh = (cache_sh, row_sh(1), slot_sh, slot_sh, scalar_sh,
                  scalar_sh, scalar_sh, row_sh(decode_chunk))
        _attach(fn, step, cache_shards)
        return fn, args, in_sh, out_sh, (1, 2, 3, 4)
    _attach(step, step, cache_shards)
    tok_sh = row_sh(1)
    return (step, (params, cache, batch_local), (params_sh, cache_sh,
                                                 batch_sh),
            (cache_sh, tok_sh), (1,))


def meta_args(args):
    """`build_cell`'s arguments as meta tensors of their local shapes
    (what a dry run traces the cell on): every `TensorSpec` of the tree
    made, nothing allocated."""
    from torch.utils import _pytree as pytree
    return pytree.tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), args,
        is_leaf=lambda x: isinstance(x, TensorSpec))


def _port_specs(cfg, max_seq: int):
    """The parameters' `TensorSpec`s in the port's per-layer layout."""
    from repro_torch.models import steps
    from repro_torch.models.layers import ParamSpec
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda s: TensorSpec(tuple(s.shape), s.dtype),
                           steps.param_specs(cfg, max_seq),
                           is_leaf=lambda x: isinstance(x, ParamSpec))


def _moment_specs(cfg, p_sds):
    """The AdamW moments' `TensorSpec`s: their parameters' shapes in
    `cfg.moment_dtype`."""
    from repro_torch.optim.adamw import DTYPES
    from torch.utils import _pytree as pytree
    dt = DTYPES[cfg.moment_dtype]
    return pytree.tree_map(lambda s: TensorSpec(s.shape, dt), p_sds,
                           is_leaf=lambda x: isinstance(x, TensorSpec))


def _port_shardings(cfg, mesh, rules, max_seq: int):
    """The plan's `Sharding` of each parameter in the port's layout (a
    stacked leaf's spec less its "layers" dim, `steps.param_partition`)."""
    from repro_torch.models import steps
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda spec: addressing.Sharding(mesh, spec),
                           steps.param_partition(cfg, mesh, rules, max_seq),
                           is_leaf=lambda x: isinstance(x, tuple))


def _attach(fn, step, cache_shards):
    fn.sharded_step, fn.shards = step, step.shards
    fn.cache_shards = cache_shards


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

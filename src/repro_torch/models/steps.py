"""Step factories: compose blocks into prefill / decode programs (the
serving half of `repro.models.steps`).

Layout differences from the reference, all for PyTorch idiom:

* ``params["blocks"]`` is a list of per-layer parameter dicts (the
  reference stacks them on a leading axis for `lax.scan`); `forward`
  and the decode step loop over it in Python.
* the decode cache is one flat dict of tensors, a group of leaves for
  each kind of layer, each leaf stacking that kind's layers on a leading
  axis (batch at axis 1): a single-kind arch has ``{"k": (L, B, S, KV,
  hd), "v": ...}`` (paged: ``(L, n_pages, page_size, KV, hd)``;
  whisper's decoder: ``self_k``/``self_v``/``cross_k``/``cross_v``); a
  mixed pattern prefixes each leaf with its kind (recurrentgemma:
  ``rglru.h``, ``rglru.conv``, ``local_attn.k``, ...), where the
  reference groups its stacked leaves by pattern position (``sub{i}`` /
  ``rem{i}``). A layer reads its kind's leaves at its place among that
  kind's layers (`cache_groups`, `layer_caches`). Every leaf is updated
  in place where the reference donates its buffers.
* an encoder-decoder model's encoder blocks are the list
  ``params["enc"]["blocks"]`` (the reference stacks them too).
* the reference's callers `jax.jit` the prefill step; the port's prefill
  step is `Graphed` (`runtime/compile_cache.py`): on the card it runs as a
  captured CUDA graph per batch shape.

* training (`loss_fn`, `make_train_step`) differentiates with autograd
  where the reference uses `jax.value_and_grad`; the fused kernels carry
  their VJPs as `torch.autograd.Function`s (`kernels/ops.py`), the chunked
  attention schedules theirs (`attention.FlashFn`). Per-layer
  recomputation (`cfg.remat`) is `torch.utils.checkpoint`; the train
  step updates its state in place where the reference donates it.
* the addressing plan (`abstract_params`, `abstract_train_state`) is over
  the reference's stacked layout, so its keys are the reference's
  (``blocks/sub0/attn/wq``, ``rem/rem0/...``, ``enc/blocks/...``);
  `param_plan_keys` maps each of the port's per-layer leaves to its key.
  `make_sharded_train_step` is the train step over a (data, model) or
  (pod, data, model) process group, each rank holding its block of the
  state as the plan places it (`state_shards`): data-parallel over the
  batch axes, tensor-parallel over "model" (`model_axis`: the blocks,
  the embedding and the vocab-parallel loss compute the plan's splits).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import numbers

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.cluster import policy as kpolicy
from repro_torch.configs.registry import TensorSpec
from repro_torch.core import addressing, collectives
from repro_torch.core import remat as remat_lib
from repro_torch.device import on_card, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blocks_lib
from repro_torch.models.blocks import BLOCKS, ModelAxis, _norm, _norm_specs
from repro_torch.models.layers import ParamSpec, layer_norm, product
from repro_torch.optim import (AdamConfig, adam_init, adam_update,
                               warmup_cosine)
from repro_torch.runtime.compile_cache import Graphed

F32 = torch.float32

AUX_COEF = 1e-2     # MoE load-balance loss weight
Z_COEF = 1e-4       # z-loss weight
LOSS_CHUNK = 512    # sequence chunk for the fused CE

# cfg.remat values forward takes under grad: "nothing" keeps each layer's
# input and recomputes the layer in backward (the reference's
# `nothing_saveable`), "none" and "everything" (everything saveable)
# recompute nothing, "dots" and "dots_no_batch" keep the layer's input
# and the outputs of its products (those without a batch index), and
# recompute the rest (`core/remat.py`)
REMAT = ("nothing", "none", "everything", "dots", "dots_no_batch")


# ----------------------------------------------------------------------------
# Layer plan and parameter specs
# ----------------------------------------------------------------------------

def block_plan(cfg) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    if cfg.family == "vlm" and cfg.cross_every:
        pattern = ("attn",) * (cfg.cross_every - 1) + ("cross",)
    else:
        pattern = cfg.pattern
    period = len(pattern)
    return pattern, cfg.n_layers // period, pattern[: cfg.n_layers % period]


def layer_kinds(cfg) -> list[str]:
    """The block kind of every layer, in order."""
    pattern, n_super, remainder = block_plan(cfg)
    return list(pattern) * n_super + list(remainder)


def param_specs(cfg, max_seq: int = 4096) -> dict:
    """`max_seq` sizes an encoder-decoder model's learned decoder
    positions (`dec_pos`)."""
    d = cfg.d_model
    specs = {
        "tok_embed": ParamSpec((cfg.vocab, d), ("vocab", None), init="embed",
                               scale=1.0),
        "unembed": ParamSpec((d, cfg.vocab), ("embed", "vocab")),
    } | _norm_specs(cfg, "ln_f")
    specs["blocks"] = [BLOCKS[k]["specs"](cfg) for k in layer_kinds(cfg)]
    if cfg.family == "encdec":
        specs["enc"] = {
            "blocks": [BLOCKS["enc_attn"]["specs"](cfg)
                       for _ in range(cfg.n_enc_layers)],
            "pos": ParamSpec((cfg.enc_seq, d), (None, None), init="embed",
                             scale=0.02),
            "ln_s": ParamSpec((d,), ("norm",), init="ones"),
            "ln_b": ParamSpec((d,), ("norm",), init="zeros"),
        }
        specs["dec_pos"] = ParamSpec((max_seq, d), (None, None),
                                     init="embed", scale=0.02)
    return specs


def iter_specs(tree):
    """Every ParamSpec leaf of a spec tree, in a fixed order."""
    if isinstance(tree, ParamSpec):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from iter_specs(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from iter_specs(item)


def _materialize(tree, generator, device, take=None):
    """Draw every leaf in `iter_specs` order; `take` (a tree of
    `LeafShard`s, or None) keeps each leaf's shard only, one leaf at a
    time."""
    if isinstance(tree, ParamSpec):
        leaf = tree.materialize(generator, device)
        return leaf if take is None else take.take(leaf)
    if isinstance(tree, dict):
        return {k: _materialize(tree[k], generator, device,
                                None if take is None else take[k])
                for k in sorted(tree)}
    return [_materialize(t, generator, device,
                         None if take is None else take[i])
            for i, t in enumerate(tree)]


def init_params(cfg, seed: int = 0, *, device=None, max_seq: int = 4096,
                shards=None):
    """Random parameters drawn on `device` (None: the GPU) from a seeded
    torch.Generator (the port cannot recreate the reference's jax.random
    streams; tests load the reference's parameters through
    `weights.from_jax_params`). `shards` (a tree of `LeafShard`s like the
    parameters) keeps each rank's shard of the same draw."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _materialize(param_specs(cfg, max_seq), gen, device, shards)


# ----------------------------------------------------------------------------
# The addressing plan's view of the parameters (the reference's layout)
# ----------------------------------------------------------------------------

def _stacked_specs(layer: dict, n: int) -> dict:
    return {k: (_stack(v, n) if isinstance(v, ParamSpec)
                else _stacked_specs(v, n)) for k, v in layer.items()}


def _ref_layout(cfg, max_seq: int = 4096) -> dict:
    """The port's parameter specs in the reference's layout: each pattern
    position's layers stacked on a leading "layers" axis under
    ``blocks/sub<i>``, the remainder layers under ``rem/rem<i>``, an
    encoder's blocks stacked under ``enc/blocks``."""
    pattern, n_super, remainder = block_plan(cfg)
    period = len(pattern)
    specs = param_specs(cfg, max_seq)
    layers = specs["blocks"]
    out = {k: v for k, v in specs.items() if k not in ("blocks", "enc")}
    out["blocks"] = {f"sub{i}": _stacked_specs(layers[i], n_super)
                     for i in range(period)}
    if remainder:
        out["rem"] = {f"rem{i}": layers[n_super * period + i]
                      for i in range(len(remainder))}
    if "enc" in specs:
        enc = specs["enc"]
        out["enc"] = {k: v for k, v in enc.items() if k != "blocks"}
        out["enc"]["blocks"] = _stacked_specs(enc["blocks"][0],
                                              len(enc["blocks"]))
    return out


def _map_dicts(fn, tree):
    """`fn` on every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_dicts(fn, v) for k, v in tree.items()}
    return fn(tree)


def abstract_params(cfg, max_seq: int = 4096):
    """(shape/dtype tree, logical tree) of the parameters in the
    reference's layout; `TensorSpec` leaves, nothing allocated."""
    specs = _ref_layout(cfg, max_seq)
    return (_map_dicts(lambda s: TensorSpec(tuple(s.shape), s.dtype), specs),
            _map_dicts(lambda s: tuple(s.logical), specs))


def abstract_train_state(cfg, max_seq: int = 4096):
    """(state shapes, state logical axes) of the train state: the moments
    take their parameters' shapes (in `moment_dtype`) and logical axes."""
    from repro_torch.optim.adamw import DTYPES
    p_sds, p_log = abstract_params(cfg, max_seq)
    mdt = DTYPES[cfg.moment_dtype]
    m_sds = _map_dicts(lambda s: TensorSpec(s.shape, mdt), p_sds)
    state_sds = {"params": p_sds,
                 "opt": {"m": m_sds, "v": m_sds,
                         "step": TensorSpec((), torch.int32)}}
    state_log = {"params": p_log,
                 "opt": {"m": p_log, "v": p_log, "step": ()}}
    return state_sds, state_log


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, the path its keys joined by
    "/" in sorted order (the reference's `tree_flatten_with_path` order
    and key form)."""
    for k in sorted(tree):
        key = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            yield from tree_paths(tree[k], key + "/")
        else:
            yield key, tree[k]


def param_plan_keys(cfg, max_seq: int = 4096):
    """A tree like the port's parameters holding, at each leaf, (its key
    in the plan, whether the plan's leaf stacks it on a "layers" axis)."""
    pattern, n_super, _ = block_plan(cfg)
    period = len(pattern)
    specs = param_specs(cfg, max_seq)

    def under(tree, prefix, stacked):
        if isinstance(tree, ParamSpec):
            return (prefix, stacked)
        return {k: under(v, f"{prefix}/{k}", stacked)
                for k, v in tree.items()}

    out = {k: under(v, k, False) for k, v in specs.items()
           if k not in ("blocks", "enc")}
    out["blocks"] = [
        under(layer, f"blocks/sub{j % period}", True) if j < n_super * period
        else under(layer, f"rem/rem{j - n_super * period}", False)
        for j, layer in enumerate(specs["blocks"])]
    if "enc" in specs:
        enc = specs["enc"]
        out["enc"] = {k: under(v, f"enc/{k}", False) for k, v in enc.items()
                      if k != "blocks"}
        out["enc"]["blocks"] = [under(layer, "enc/blocks", True)
                                for layer in enc["blocks"]]
    return out


def param_partition(cfg, mesh, rules, max_seq: int = 4096):
    """Each of the port's parameter leaves' spec on `mesh` under `rules`:
    the plan's spec of its key, less the stacked "layers" dim (which the
    plan never splits)."""
    p_sds, p_log = abstract_params(cfg, max_seq)
    shapes, logical = dict(tree_paths(p_sds)), dict(tree_paths(p_log))

    def one(leaf):
        key, stacked = leaf
        spec = rules.spec_for(logical[key], shapes[key].shape, mesh)
        if not stacked:
            return spec
        if spec and spec[0] is not None:
            raise NotImplementedError(f"{key}: the plan splits the stacked "
                                      f"layers axis ({spec})")
        return spec[1:]

    return pytree.tree_map(one, param_plan_keys(cfg, max_seq),
                           is_leaf=lambda x: isinstance(x, tuple))


# cited by the refusal below (the dry run records its cells as refused
# with this text)
UNSPLIT_ITEM = ("ROADMAP Queue 3, \"Splits over 'model' the port does not "
                "compute\"")


def check_mesh(cfg, mesh, rules=None, *, max_seq: int = 4096
               ) -> tuple[int, int]:
    """(batch ranks, model ranks) of a mesh the sharded step runs `cfg`
    on: axes "data" (and "pod"), the batch axes, and "model"; any other
    axis of size 1. With a "model" axis every dim the plan splits over
    it (under `rules`; None: the arch's own, `cfg.rules_overrides`) must
    be one the step computes (`_MODEL_SPLITS`): a split of any other
    raises NotImplementedError naming its ROADMAP item. Takes a
    `MeshSpec` or a live mesh."""
    sizes = _check_axes(mesh)
    if "model" in sizes:
        rules = rules or addressing.default_rules(
            mesh, overrides=cfg.rules_overrides)
        _model_dims(cfg, mesh, rules, max_seq)
    batch = math.prod(sizes[a] for a in addressing.BATCH_AXES if a in sizes)
    return batch, sizes.get("model", 1)


def _check_axes(mesh) -> dict:
    """The mesh's axis sizes, raising for a mesh the sharded step does
    not take (no "data" axis, an axis above 1 outside the batch axes and
    "model")."""
    sizes = addressing.mesh_axes(mesh)
    if "data" not in sizes:
        raise ValueError(f"mesh axes {tuple(sizes)} have no 'data' axis")
    known = (*addressing.BATCH_AXES, "model")
    other = {a: n for a, n in sizes.items() if a not in known and n > 1}
    if other:
        raise NotImplementedError(f"mesh {sizes}: the sharded step takes "
                                  f"the axes {known}, not {other}")
    return sizes


def _split_dims(spec, axes) -> list[int]:
    """The dims of `spec` split over any of `axes`."""
    return [d for d in range(len(spec))
            if set(addressing.spec_axes(spec, d)) & set(axes)]


def _shard_maker(mesh, device):
    """`one(key, spec) -> LeafShard` of this rank on a live mesh: a dim
    split over the batch axes is spread over their process group
    (`addressing.batch_group`), a dim split over "model" over the model
    axis's; a leaf may have one of each."""
    sizes = addressing.mesh_axes(mesh)
    coords = addressing.coordinates(mesh)
    bgroup = addressing.batch_group(mesh)
    mgroup = mesh.get_group("model") if "model" in sizes else None
    present = [a for a in addressing.BATCH_AXES if a in sizes]

    def one(key, spec):
        bdims = _split_dims(spec, addressing.BATCH_AXES)
        mdims = _split_dims(spec, ("model",))
        if len(bdims) > 1 or len(mdims) > 1 or (set(bdims) & set(mdims)):
            raise NotImplementedError(
                f"{key}: spec {spec} splits more than one dim over the "
                f"batch axes or the model axis, or one dim over both")
        kw = {}
        if bdims:
            axes = addressing.spec_axes(spec, bdims[0])
            if [a for a in present if sizes[a] > 1 and a not in axes]:
                raise NotImplementedError(
                    f"{key}: spec {spec} splits dim {bdims[0]} over {axes}, "
                    f"not over every batch axis of mesh {sizes}")
            index, parts = addressing.block_index(axes, mesh, coords)
            kw = dict(dim=bdims[0], index=index, parts=parts, group=bgroup)
        if mdims:
            kw |= dict(model_dim=mdims[0], model_index=coords["model"],
                       model_parts=sizes["model"], model_group=mgroup)
        return addressing.LeafShard(**{"dim": None, **kw}, device=device)

    return one


def state_shards(cfg, mesh, rules, *, device=None, max_seq: int = 4096):
    """A `LeafShard` for every leaf of the train state on this rank: a
    parameter's and its two moments' from the parameter's spec (ZeRO-1:
    the moments follow their parameters), the step count whole. A dim
    split over the batch axes is spread over their process group
    (`addressing.batch_group`), a dim split over "model" over the model
    axis's; a leaf may have one of each (w_down: ffn over model, embed
    over data). Needs a live DeviceMesh (a rank's coordinates come from
    it)."""
    check_mesh(cfg, mesh, rules, max_seq=max_seq)
    one = _shard_maker(mesh, device)
    params = pytree.tree_map_with_path(
        lambda path, spec: one("/".join(str(k) for k in _path_key(path)),
                               spec),
        param_partition(cfg, mesh, rules, max_seq),
        is_leaf=lambda x: isinstance(x, tuple))
    return {"params": params,
            "opt": {"m": params, "v": params,
                    "step": addressing.LeafShard(None, device=device)}}


# (parent key, leaf, dim) -> the ModelAxis field a split of that dim over
# "model" sets; no other dim may be split. The parent of a leaf under an
# attention, FFN or expert sub-block is the sub-block's key (whisper's
# decoder: "self", "cross"); that of a leaf directly under a layer is the
# layer's kind (the RG-LRU's)
_ATTN_SPLITS = {("wq", 1): "heads", ("wo", 0): "heads", ("bq", 0): "heads",
                ("wk", 1): "kv_heads", ("wv", 1): "kv_heads",
                ("bk", 0): "kv_heads", ("bv", 0): "kv_heads"}
_MODEL_SPLITS = {
    **{(parent, leaf, d): field for parent in ("attn", "self", "cross")
       for (leaf, d), field in _ATTN_SPLITS.items()},
    ("ffn", "w_gate", 1): "ffn", ("ffn", "w_up", 1): "ffn",
    ("ffn", "w_down", 0): "ffn",
    ("ffn", "w_in", 1): "ffn", ("ffn", "b_in", 0): "ffn",
    ("ffn", "w_out", 0): "ffn",
    ("moe", "w_gate", 2): "expert_ffn", ("moe", "w_up", 2): "expert_ffn",
    ("moe", "w_down", 1): "expert_ffn",
    **{("rglru", leaf, d): "lru" for leaf, d in (
        ("w_x", 1), ("w_gate", 1), ("conv_w", 1), ("w_ra", 0), ("b_ra", 0),
        ("w_ix", 0), ("b_ix", 0), ("lam", 0), ("w_out", 0))},
    # xlstm's blocks: the inner width di, w_up's 2 di columns (gate and
    # main), w_in's 4 di (the four gates) and the cells' heads
    **{("mlstm", leaf, d): "inner" for leaf, d in (
        ("conv_w", 1), ("wq", 0), ("wk", 0), ("wv", 0), ("w_i", 0),
        ("w_f", 0), ("w_down", 0))},
    ("mlstm", "w_up", 1): "inner_up",
    **{("mlstm", leaf, 0): "cell_heads" for leaf in ("b_i", "b_f",
                                                      "ogate_ln")},
    ("slstm", "w_in", 1): "inner_gates", ("slstm", "b", 0): "inner_gates",
    ("slstm", "w_out", 0): "inner", ("slstm", "r_h", 1): "cell_heads",
    ("", "tok_embed", 0): "vocab", ("", "unembed", 1): "vocab",
}


def _model_dims(cfg, mesh, rules, max_seq: int) -> list:
    """(field, dim, spec, shape) of every dim of `_MODEL_SPLITS` in each
    parameter leaf, in the plan of `mesh` under `rules`; raises
    NotImplementedError where the plan splits any other dim over
    "model"."""
    kinds = layer_kinds(cfg)
    specs = param_partition(cfg, mesh, rules, max_seq)
    shapes = pytree.tree_map(lambda s: tuple(s.shape),
                             param_specs(cfg, max_seq),
                             is_leaf=lambda x: isinstance(x, ParamSpec))
    out = []

    def one(path, spec, shape):
        keys = _path_key(path)
        names = [k for k in keys if isinstance(k, str)]
        parent = names[-2] if len(names) > 1 else ""
        if keys[0] == "blocks" and len(names) == 2:
            parent = kinds[keys[1]]
        elif keys[:2] == ("enc", "blocks") and len(names) == 3:
            parent = "enc_attn"
        split = _split_dims(spec, ("model",))
        for d in range(len(shape)):
            field = _MODEL_SPLITS.get((parent, names[-1], d))
            if field is not None:
                out.append((field, d, spec, shape))
            elif d in split:
                raise NotImplementedError(
                    f"{'/'.join(map(str, keys))} ({parent}): the plan "
                    f"splits dim {d} over 'model' ({spec}), which the "
                    f"sharded step does not compute ({UNSPLIT_ITEM})")

    pytree.tree_map_with_path(one, specs, shapes,
                              is_leaf=lambda x: isinstance(x, tuple))
    return out


def model_axis(cfg, mesh, rules, *, max_seq: int = 4096) -> ModelAxis | None:
    """The `ModelAxis` of this rank on a live mesh (None without a
    "model" axis), for every block kind: for each dim the plan may split
    over "model" (the heads, KV heads, d_ff, lru width, xlstm's inner
    width and cell heads, and vocab dims of `_MODEL_SPLITS`), whether it
    does, and this rank's block of it (`addressing.local_block`). Where
    the plan keeps every such dim of a block whole (xlstm's under its own
    rules) the block runs whole on every model rank, as on one device.
    Every leaf holding such a dim must be split alike (xlstm's inner
    width with w_up's and w_in's columns); a split of any other dim
    raises NotImplementedError (`check_mesh`)."""
    sizes = _check_axes(mesh)
    if "model" not in sizes:
        return None
    coords = addressing.coordinates(mesh)
    seen: dict[str, set] = {}
    for field, d, spec, shape in _model_dims(cfg, mesh, rules, max_seq):
        block = addressing.local_block(spec, shape, mesh, coords)[d]
        seen.setdefault(field, set()).add(
            (block.start, block.stop) if d in _split_dims(spec, ("model",))
            else None)
    for field, got in seen.items():
        if len(got) > 1:
            raise NotImplementedError(
                f"the plan splits some of the {field} dims over 'model' "
                f"and keeps others whole: {sorted(got, key=str)}")
    at = {f: next(iter(g)) for f, g in seen.items()}
    owned = {f: None if at.get(f) is None else slice(*at[f])
             for f in ("heads", "kv_heads", "vocab", "lru", "inner",
                       "cell_heads")}
    if owned["kv_heads"] is not None and owned["heads"] is None:
        raise NotImplementedError("the plan splits the KV heads over "
                                  "'model' and keeps the query heads whole")
    inner = {f: at.get(f) is not None for f in ("inner", "inner_up",
                                                "inner_gates")
             if f in at}
    if len(set(inner.values())) > 1 or (owned["cell_heads"] is not None
                                        and owned["inner"] is None):
        raise NotImplementedError(
            f"the plan splits some of xlstm's inner width over 'model' and "
            f"keeps the rest whole ({inner}, cell heads "
            f"{owned['cell_heads']})")
    return ModelAxis(mesh.get_group("model"), coords["model"],
                     sizes["model"], ffn=at.get("ffn") is not None,
                     expert_ffn=at.get("expert_ffn") is not None, **owned)


def _path_key(path) -> tuple:
    """A pytree key path as plain keys and indices."""
    return tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)


def _by_path(tree) -> dict:
    """{key path: LeafShard} of a tree of `LeafShard`s."""
    flat, _ = pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, addressing.LeafShard))
    return {_path_key(path): leaf for path, leaf in flat}


# ----------------------------------------------------------------------------
# Decode caches
# ----------------------------------------------------------------------------

def _stack(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec((n, *spec.shape), ("layers", *spec.logical), spec.dtype,
                     spec.init, spec.scale)


def cache_groups(cfg) -> list[tuple[str, str, list[int]]]:
    """(key prefix, kind, layers) for each kind of layer, in the order the
    kinds first appear: one group without a prefix when every layer is of
    one kind, else a group a kind whose leaves are named "<kind>.<leaf>"."""
    kinds = layer_kinds(cfg)
    order = list(dict.fromkeys(kinds))
    return [("" if len(order) == 1 else f"{kind}.", kind,
             [i for i, k in enumerate(kinds) if k == kind])
            for kind in order]


def cache_specs(cfg, B: int, cache_len: int) -> dict:
    specs = {}
    for prefix, kind, layers in cache_groups(cfg):
        one = BLOCKS[kind]["cache"](cfg, B, cache_len)
        specs |= {prefix + k: _stack(s, len(layers)) for k, s in one.items()}
    return specs


def layer_caches(cfg) -> list[tuple[dict, int]]:
    """For each layer: {its block's cache leaf: the cache key} and its
    index on those keys' leading axis."""
    out = [None] * cfg.n_layers
    for prefix, kind, layers in cache_groups(cfg):
        leaves = BLOCKS[kind]["cache"](cfg, 1, 1)
        for j, i in enumerate(layers):
            out[i] = ({k: prefix + k for k in leaves}, j)
    return out


def _zeros(specs: dict, device, shards=None) -> dict:
    """Zero leaves of `specs`; with `shards` ({leaf: LeafShard}) each
    leaf's block of this rank."""
    device = resolve_device(device)
    return {k: torch.zeros(s.shape if shards is None
                           else shards[k].local_shape(s.shape),
                           dtype=s.dtype, device=device)
            for k, s in specs.items()}


def init_cache(cfg, B: int, cache_len: int, *, device=None, shards=None):
    """The zero decode cache of B slots and cache_len rows; with `shards`
    (`cache_shards`) this rank's blocks of it."""
    return _zeros(cache_specs(cfg, B, cache_len), device, shards)


def fill_cache_slots(cache, mask, value):
    """Fill the masked batch rows (mask: (B,) bool tensor) of every leaf
    with `value`, in place. Integer leaves are left untouched when `value`
    is not finite (NaN fault injection must not touch integer state)."""
    finite = math.isfinite(value)
    for c in cache.values():
        if finite or c.is_floating_point():
            c[:, mask] = value
    return cache


def zero_cache_slots(cache, mask):
    """Zero the masked batch rows (mask: (B,) bool tensor), in place."""
    return fill_cache_slots(cache, mask, 0.0)


def take_cache_slot(cache, slot):
    """A copy of slot `slot`'s rows of every leaf (the device half of a slot
    snapshot). A copy, not a view: a captured session step overwrites the
    live rows at its next replay."""
    return {k: c.select(1, slot).clone() for k, c in cache.items()}


def put_cache_slot(cache, slot, rows):
    """Write `rows` (a `take_cache_slot` result) back into slot `slot`, in
    place and bit for bit."""
    for k, c in cache.items():
        c.select(1, slot).copy_(rows[k])
    return cache


def _nan_along(c, axis: int):
    """(c.shape[axis],) bool: any NaN in each index of `axis` (one
    reduction over the other axes, no copy of the mask)."""
    return torch.isnan(c).any(dim=tuple(d for d in range(c.ndim)
                                        if d != axis))


def nan_cache_slots(cache):
    """(B,) bool tensor: any NaN in a slot's rows of any float leaf (the
    corruption sentinel the session scans after a chunk)."""
    out = None
    for c in cache.values():
        if c.is_floating_point():
            f = _nan_along(c, 1)
            out = f if out is None else out | f
    return out


def decode_cache_len(cfg, seq_len: int) -> int:
    """Physical cache length: windowed archs keep a rolling window buffer."""
    if cfg.window and cfg.window < seq_len:
        return cfg.window
    return seq_len


# Under a paged session the positional K/V leaves stop being per-slot
# rectangles (L, B, S, KV, hd) and become one shared pool (L, n_pages,
# page_size, KV, hd) addressed through per-slot page tables. Rolling-window
# buffers and static context (whisper's cross K/V) are not pageable and
# stay private (L, B, ...) leaves; the two kinds coexist in one cache dict
# and every per-slot op routes each leaf by `paged_cache_mask`.

def _kind_paged(cfg, kind: str) -> bool:
    """Does this block kind route K/V through the pool? Positional
    attention pages, windowed attention keeps a private rolling buffer
    (the `_paged(ctx, window)` gate of the blocks)."""
    if kind in ("attn", "attn_moe"):
        return not cfg.window
    return kind == "attn_cross"        # self_k/self_v (cross_* is static)


def _pageable_leaf(spec: ParamSpec) -> bool:
    return tuple(spec.logical[:2]) == ("batch", "kv_seq")


def paged_cache_mask(cfg, B: int, cache_len: int) -> dict:
    """{cache leaf: True on a pool leaf} — the routing fact every paged
    per-slot op shares, decided for each kind's group of leaves (the
    reference decides it for each `sub{i}` / `rem{i}`)."""
    mask = {}
    for prefix, kind, _ in cache_groups(cfg):
        paged = _kind_paged(cfg, kind)
        mask |= {prefix + k: paged and _pageable_leaf(s)
                 for k, s in BLOCKS[kind]["cache"](cfg, B, cache_len).items()}
    return mask


def paged_cache_specs(cfg, B: int, cache_len: int, *, n_pages: int,
                      page_size: int) -> dict:
    """`cache_specs` with every pageable K/V leaf replaced by the shared
    pool (L, n_pages, page_size, KV, hd); private leaves as they are."""
    mask = paged_cache_mask(cfg, B, cache_len)
    if not any(mask.values()):
        raise ValueError(
            f"arch {cfg.name!r} has no pageable KV leaves (recurrent or "
            f"fully windowed) — paged serving needs positional attention")
    return {k: (ParamSpec((s.shape[0], n_pages, page_size, *s.shape[3:]),
                          ("layers", None, None, *s.logical[3:]), s.dtype,
                          s.init) if mask[k] else s)
            for k, s in cache_specs(cfg, B, cache_len).items()}


def init_paged_cache(cfg, B: int, cache_len: int, *, n_pages: int,
                     page_size: int, device=None, shards=None):
    """The zero paged cache; with `shards` (`cache_shards(n_pages=,
    page_size=)`) this rank's blocks of it."""
    return _zeros(paged_cache_specs(cfg, B, cache_len, n_pages=n_pages,
                                    page_size=page_size), device, shards)


def abstract_cache(cfg, B: int, cache_len: int):
    """(shape/dtype, logical axes) of each decode cache leaf, in the
    port's layout (`cache_specs`: a kind's layers stacked on a leading
    "layers" axis, which the plan keeps whole; the reference stacks a
    pattern position's layers the same way)."""
    specs = cache_specs(cfg, B, cache_len)
    return ({k: TensorSpec(tuple(v.shape), v.dtype) for k, v in specs.items()},
            {k: tuple(v.logical) for k, v in specs.items()})


def abstract_paged_cache(cfg, B: int, cache_len: int, *, n_pages: int,
                         page_size: int):
    """`abstract_cache` of a paged cache: each pool leaf's logical axes
    ("layers", None, None, "kv_heads", None), so the plan splits the pool
    by its KV heads only."""
    specs = paged_cache_specs(cfg, B, cache_len, n_pages=n_pages,
                              page_size=page_size)
    return ({k: TensorSpec(tuple(v.shape), v.dtype) for k, v in specs.items()},
            {k: tuple(v.logical) for k, v in specs.items()})


def cache_shards(cfg, mesh, rules, B: int, cache_len: int, *,
                 n_pages: int | None = None, page_size: int | None = None,
                 device=None) -> dict:
    """A `LeafShard` for each decode cache leaf of a (B, cache_len)
    workload on this rank of a live mesh, from the plan's spec of the
    leaf (`abstract_cache`; with `n_pages` / `page_size`, the paged
    cache's): a K/V leaf's slots over the batch axes and its kv_seq over
    "model" (its kv_heads where the model size does not divide
    cache_len), a pool leaf by its KV heads, as `addressing.default_rules`
    places them."""
    check_mesh(cfg, mesh, rules)
    if n_pages is None:
        sds, log = abstract_cache(cfg, B, cache_len)
    else:
        sds, log = abstract_paged_cache(cfg, B, cache_len, n_pages=n_pages,
                                        page_size=page_size)
    one = _shard_maker(mesh, device)
    return {k: one(k, rules.spec_for(log[k], sds[k].shape, mesh))
            for k in sds}


def cache_split(cfg, mesh, rules, cache_len: int):
    """The `blocks.CacheSplit` of this rank: where the plan puts the
    attention kinds' K/V over "model" in a private cache of `cache_len`
    rows (kv_seq, else kv_heads, else whole: the reference's rules with
    their divisibility and axis-conflict fallback), in the paged pool
    (kv_heads or whole) and in a cross-attention cache (whisper's cross
    K/V, vision's image K/V: kv_heads or whole). None without a "model"
    axis. The recurrent caches (the RG-LRU's h and conv over the lru
    width, xlstm's over its heads) are each rank's block of the plan
    (`cache_shards`), as the parameters' splits (`ModelAxis`) compute
    them."""
    sizes = addressing.mesh_axes(mesh)
    if "model" not in sizes:
        return None
    coords = addressing.coordinates(mesh)
    batch = math.prod(sizes[a] for a in addressing.BATCH_AXES if a in sizes)
    kv, hd = cfg.n_kv_heads, cfg.hd

    def owned(logical, shape, dim):
        """This rank's slice of dim `dim` (kv_seq 2 or kv_heads 3), None
        where it is whole; the batch axes may split the slots (dim 1)."""
        spec = rules.spec_for(logical, shape, mesh)
        for d in range(len(shape)):
            axes = set(addressing.spec_axes(spec, d))
            if (d != 1 and axes - {"model"}) or (axes and d not in (1, 2, 3)):
                raise NotImplementedError(
                    f"the plan splits cache dim {d} over {axes} ({spec}), "
                    f"which the sharded decode does not compute")
        if "model" not in addressing.spec_axes(spec, dim):
            return None
        return addressing.local_block(spec, shape, mesh, coords)[dim]

    private = (("layers", "batch", "kv_seq", "kv_heads", None),
               (1, batch, cache_len, kv, hd))
    pool = (("layers", None, None, "kv_heads", None), (1, 1, 1, kv, hd))
    cross = (("layers", "batch", None, "kv_heads", None),
             (1, batch, 1, kv, hd))
    return blocks_lib.CacheSplit(cache_len=cache_len,
                                 rows=owned(*private, 2),
                                 heads=owned(*private, 3),
                                 pool_heads=owned(*pool, 3),
                                 cross_heads=owned(*cross, 3))


def make_paged_cache_ops(cfg, B: int, cache_len: int):
    """The per-slot / per-page device ops of a paged cache, in place,
    routed by `paged_cache_mask`:

    * ``zero_slots(cache, mask)`` — refill zeroing of the private leaves
      only (pool pages are deliberately not zeroed: stale data is masked
      out by decode attention);
    * ``copy_pages(cache, src, dst)`` — pool page copy (the COW fork);
    * ``zero_pages(cache, pages)`` — pool page scrub;
    * ``nan_slots(cache, tables)`` — (B,) bool: a NaN in a slot's private
      rows or in a pool page its table maps (trash-page entries ignored,
      so one poisoned slot does not flag its retired neighbours);
    * ``corrupt_slots(cache, mask, tables)`` — NaN into the masked slots'
      private rows and every page their tables map (fault injection);
    * ``read_pages(cache, pages)`` — the listed pages of every pool leaf,
      page axis first ((n, L, page_size, ...)), for the checksums;
    * ``flip_pages(cache, pages)`` — +1 on the listed pages' float values
      (the silent, finite `bit_flip` fault)."""
    paged_cache_specs(cfg, B, cache_len, n_pages=2, page_size=1)  # validate
    mask = paged_cache_mask(cfg, B, cache_len)
    pools = [k for k, m in mask.items() if m]
    private = [k for k, m in mask.items() if not m]

    def zero_slots(cache, slot_mask):
        zero_cache_slots({k: cache[k] for k in private}, slot_mask)
        return cache

    def copy_pages(cache, src, dst):
        for key in pools:
            c = cache[key]
            s = torch.as_tensor(src, device=c.device).long()
            d = torch.as_tensor(dst, device=c.device).long()
            for pool in c:                      # one layer's pool
                attn_lib.copy_page(pool, s, d)
        return cache

    def zero_pages(cache, pages):
        for key in pools:
            for pool in cache[key]:
                attn_lib.zero_pages(pool, pages)
        return cache

    def nan_slots(cache, tables):
        tables = tables.long()
        live = tables != 0                       # trash-page entries
        out = None
        for key, paged in mask.items():
            c = cache[key]
            if not c.is_floating_point():
                continue
            if paged:
                f = (_nan_along(c, 1)[tables] & live).any(1)
            else:
                f = _nan_along(c, 1)
            out = f if out is None else out | f
        return out

    def corrupt_slots(cache, slot_mask, tables):
        rows = tables.long()[slot_mask]
        hit = rows[rows != 0]
        for key, paged in mask.items():
            c = cache[key]
            if c.is_floating_point():
                c[:, hit if paged else slot_mask] = float("nan")
        return cache

    def read_pages(cache, pages):
        out = []
        for key in pools:
            c = cache[key]
            idx = torch.as_tensor(pages, device=c.device).long()
            out.append(c[:, idx].movedim(1, 0))
        return tuple(out)

    def flip_pages(cache, pages):
        for key in pools:
            c = cache[key]
            if c.is_floating_point():
                idx = torch.as_tensor(pages, device=c.device).long()
                c[:, idx] += 1
        return cache

    return {"zero_slots": zero_slots, "copy_pages": copy_pages,
            "zero_pages": zero_pages, "nan_slots": nan_slots,
            "corrupt_slots": corrupt_slots, "read_pages": read_pages,
            "flip_pages": flip_pages}


# ----------------------------------------------------------------------------
# Forward, prefill, decode
# ----------------------------------------------------------------------------

def _final_norm(cfg, params, x):
    return _norm(cfg, params, "ln_f", x)


def _remat(cfg) -> str | None:
    """The remat policy of forward's layers: None where nothing is
    recomputed (without grad, and under cfg.remat "none" /
    "everything"), else cfg.remat (see REMAT)."""
    if not torch.is_grad_enabled() or cfg.remat in ("none", "everything"):
        return None
    if cfg.remat not in REMAT:
        raise ValueError(f"unknown remat policy {cfg.remat!r}; the port "
                         f"takes {REMAT}")
    return cfg.remat


def _layer(remat: str | None, apply, *args):
    """One layer, `apply(*args)`. Under `remat` "nothing" only its inputs
    are kept and backward runs it again; under "dots" / "dots_no_batch"
    its products' outputs are kept too (`core.remat.contexts`), and the
    recompute reads them back in place of their products. The policy
    scope of the step is still active in the recompute, so it takes the
    same kernels, and it issues the layer's collectives again on every
    rank."""
    if remat is None:
        return apply(*args)
    kw = {} if remat == "nothing" else {"context_fn": remat_lib.contexts(
        remat)}
    return checkpoint(apply, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _encode(cfg, params, enc_embeds, axis: ModelAxis | None = None):
    """Whisper's encoder over stub frame embeddings (B, enc_seq, d); with
    `axis` its blocks compute this rank's splits, as the decoder's do."""
    enc = params["enc"]
    x = enc_embeds + enc["pos"].to(enc_embeds.dtype)
    B, S = x.shape[:2]
    ctx = {"positions": torch.arange(S, device=x.device).expand(B, S),
           "rope": False, "model_axis": axis}
    remat = _remat(cfg)
    for p in enc["blocks"]:
        x, _ = _layer(remat, BLOCKS["enc_attn"]["apply"], cfg, p, x, ctx)
    return layer_norm(x, enc["ln_s"], enc["ln_b"])


def logits(params, hidden):
    """Vocabulary projection with f32 accumulation and f32 output (rounding
    logits to bf16 would flip argmax ties). A plain product, outside any
    kernel: on the GPU one bf16 GEMM with an f32 result, elsewhere an f32
    product of the upcast operands (the same function)."""
    w = params["unembed"]
    if on_card(hidden) and hidden.dtype == w.dtype == torch.bfloat16:
        return product("...d,dv->...v", hidden, w, F32)
    return hidden.to(F32) @ w.to(F32)


def _embed(table, tokens, axis: ModelAxis | None = None):
    """The token embeddings; with `axis` splitting the vocabulary (the
    tensor-parallel step), each rank looks up the tokens in its rows,
    zeros elsewhere, and `reduce_from_ranks` sums the ranks' lookups (one
    rank holds each row: the sum is exact)."""
    if axis is None or axis.vocab is None:
        return table[tokens.long()]
    ids = tokens.long() - axis.vocab.start
    own = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    return collectives.reduce_from_ranks(
        torch.where(own[..., None], rows, rows.new_zeros(())), axis.group)


def forward(cfg, params, tokens, *, cross_embeds=None,
            axis: ModelAxis | None = None, group=None, layer_gather=None):
    """Token ids (B, S) -> final hidden states (B, S, d) and aux loss. An
    encoder-decoder model encodes `cross_embeds` (its stub frame
    embeddings) first and adds its learned decoder positions; a vision
    model's cross blocks take `cross_embeds` (its image embeddings) as
    they come. The sharded train step passes its `ModelAxis` (`axis`:
    the embedding and the blocks compute this rank's splits) and its
    batch ranks' group (`group`: MoE layers dispatch over every rank's
    tokens); the blocks read both from their context. With
    `layer_gather` (the step's per-layer gather, `fsdp_gather`) each
    layer of ``params["blocks"]``, the reference's remainder layers
    included, computes with `layer_gather(i, p)`, called inside the
    layer's checkpointed span: a recompute gathers again.

    Where `axis` splits the heads the cross context (the encoder output,
    the image embeddings) enters through `copy_to_ranks` once: every
    layer's split cross-attention projects this rank's KV heads of it,
    so a rank's gradient of it is its heads' share, summed over the
    model ranks before the encoder's backward."""
    kinds = layer_kinds(cfg)
    B, S = tokens.shape
    x = _embed(params["tok_embed"], tokens, axis)
    encdec = cfg.family == "encdec"
    if encdec:
        cross_embeds = _encode(cfg, params, cross_embeds, axis)
        x = x + params["dec_pos"][:S].to(x.dtype)
    if cross_embeds is not None and axis is not None and \
            axis.heads is not None:
        cross_embeds = collectives.copy_to_ranks(cross_embeds, axis.group)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    ctx = {"positions": positions, "rope": not encdec,
           "cross_embeds": cross_embeds, "max_seq": S,
           "model_axis": axis, "dispatch_group": group}
    aux = 0.0
    remat = _remat(cfg)
    for i, (kind, p) in enumerate(zip(kinds, params["blocks"])):
        apply = BLOCKS[kind]["apply"]
        if layer_gather is not None:
            apply = functools.partial(_gathered, apply, layer_gather, i)
        x, a = _layer(remat, apply, cfg, p, x, ctx)
        aux = aux + a
    return _final_norm(cfg, params, x), aux


def _gathered(apply, gather, i, cfg, p, *args):
    """`apply` on layer i's parameters as `gather` makes them."""
    return apply(cfg, gather(i, p), *args)


# ----------------------------------------------------------------------------
# Loss (chunked over the sequence; the logits never exist at (B, S, V))
# ----------------------------------------------------------------------------

def _ce_block(unembed, h, y, axis: ModelAxis | None = None):
    """One chunk's summed NLL and z-loss; h (B, c, d), y (B, c). The
    logsumexp is the max (no gradient) plus the log of the summed exp.
    With `axis` splitting the vocabulary (the tensor-parallel step) it is
    vocab-parallel: h enters through `copy_to_ranks`, each rank holds its
    columns' f32 logits, the max is taken over the ranks, the sums of exp
    and the label's logit (from the rank that owns it) are summed over
    them (`reduce_from_ranks`), and the z-loss is on the global lse; the
    logits never exist whole. At one rank the arithmetic is the same."""
    vocab = None if axis is None else axis.vocab
    if vocab is not None:
        h = collectives.copy_to_ranks(h, axis.group)
    lg = logits({"unembed": unembed}, h)               # (B, c, V / model)
    m = lg.detach().amax(dim=-1)
    if vocab is not None:
        m = collectives.max_over_ranks(m, axis.group)
    sums = torch.exp(lg - m[..., None]).sum(dim=-1)
    if vocab is not None:
        sums = collectives.reduce_from_ranks(sums, axis.group)
    lse = m + torch.log(sums)
    if vocab is None:
        ll = torch.gather(lg, -1, y.long()[..., None])[..., 0]
    else:
        ids = y.long() - vocab.start
        own = (ids >= 0) & (ids < lg.shape[-1])
        ll = torch.gather(lg, -1, ids.clamp(0, lg.shape[-1] - 1)[..., None])
        ll = collectives.reduce_from_ranks(
            torch.where(own, ll[..., 0], 0.0), axis.group)
    return (lse - ll).sum(), Z_COEF * torch.square(lse).sum()


def _chunked_ce(cfg, unembed, hidden, labels, axis=None):
    """Mean cross-entropy plus z-loss over (B, S), LOSS_CHUNK positions at
    a time (S when S is not a multiple). Under grad each chunk is
    recomputed in backward, so one chunk's f32 logits are all that ever
    exists (the reference's `jax.checkpoint` scan body)."""
    B, S, _ = hidden.shape
    c = min(LOSS_CHUNK, S)
    if S % c:
        c = S
    remat = "nothing" if torch.is_grad_enabled() else None
    total = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(S // c):
        cols = slice(i * c, (i + 1) * c)
        nll, z = _layer(remat, _ce_block, unembed, hidden[:, cols],
                        labels[:, cols], axis)
        total = total + nll + z
    return total / (B * S)


def loss_fn(cfg, params, batch, *, axis: ModelAxis | None = None,
            group=None, layer_gather=None):
    """(loss, {"ce", "aux"}) of one batch: the chunked CE plus AUX_COEF x
    the MoE load-balance loss (0 without MoE layers). `axis`, `group` and
    `layer_gather` as `forward` takes them."""
    cross = batch.get("enc_embeds", batch.get("img_embeds"))
    hidden, aux = forward(cfg, params, batch["tokens"], cross_embeds=cross,
                          axis=axis, group=group, layer_gather=layer_gather)
    ce = _chunked_ce(cfg, params["unembed"], hidden, batch["labels"], axis)
    aux = torch.as_tensor(aux, device=ce.device).to(F32)
    return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------------------
# Train step
# ----------------------------------------------------------------------------

def _on(device, batch: dict) -> dict:
    """The batch's arrays as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _acc_dtype(cfg):
    """The dtype gradients accumulate in over microbatches: f32, bf16
    when the moments are bf16."""
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else F32


def make_train_step(cfg, *, adam: AdamConfig | None = None,
                    schedule_kwargs: dict | None = None, policy=None,
                    axis: ModelAxis | None = None, group=None,
                    layers: _LayerGather | None = None):
    """`train_step(state, batch) -> (state, metrics)`, the state updated
    in place (the reference donates it). `policy` pins the kernel policy
    (None -> the ambient one); its scope covers the forward and the
    backward, so a recomputed layer takes the forward's kernels.

    With cfg.grad_accum = k > 1 the batch is cut into k microbatches along
    its rows (a batch of fewer rows than k into a microbatch a row: a
    batch rank of a large mesh may hold fewer rows than grad_accum, where
    the reference's compiler pads each microbatch over the ranks), each
    one's gradients taken with `torch.autograd.grad` and
    added into an accumulator of `acc_dtype` (f32, bf16 when the moments
    are bf16), which is divided by k: the metrics are the mean loss, the
    learning-rate scale and the gradient norm. With k = 1 the metrics also
    hold the loss's parts ("ce", "aux"). Metrics are 0-d tensors on the
    device; nothing is read back to the host. The step's halves are
    `train_step.accumulate(params, batch) -> (loss, parts, grads)` and
    `train_step.update(state, grads) -> (opt, metrics)`, each in the
    policy's scope. `axis` and `group` go to `loss_fn` (the sharded
    step's model axis and batch ranks; None on one device). With `layers`
    (the sharded step's per-layer gather, `fsdp_gather`) `loss_fn`
    gathers each decoder layer's leaves that `layers` holds as the layer
    runs, and their gradients are its accumulators (this rank's blocks
    of the means over the batch ranks, in f32), not autograd's."""
    pol = kpolicy.as_policy(policy) if policy is not None else None
    adam = adam or AdamConfig(moment_dtype=cfg.moment_dtype)
    sched = functools.partial(warmup_cosine, **(schedule_kwargs or {}))
    acc_dtype = _acc_dtype(cfg)

    def grads_of(params, batch):
        """(loss, parts, grads); a leaf `layers` holds has no grad here
        (None)."""
        flat, spec = pytree.tree_flatten_with_path(params)
        held = [layers is not None and layers.held(path) for path, _ in flat]
        live = [p if h else p.detach().requires_grad_()
                for (_, p), h in zip(flat, held)]
        wrt = [p for p, h in zip(live, held) if not h]
        if layers is not None:
            wrt.append(layers.token)
        loss, parts = loss_fn(cfg, pytree.tree_unflatten(live, spec), batch,
                              axis=axis, group=group, layer_gather=layers)
        grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                         materialize_grads=True))
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                pytree.tree_unflatten([None if h else next(grads)
                                       for h in held], spec))

    def accumulate(params, batch):
        """(loss, parts, grads) of the batch, over its k microbatches."""
        device = pytree.tree_leaves(params)[0].device
        batch = _on(device, batch)
        k = micro_count(cfg, batch)
        if layers is not None:
            layers.start(device, k)
        if k <= 1:
            loss, parts, grads = grads_of(params, batch)
            return loss, parts, _filled(grads, params)
        micro = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])
                 for key, v in batch.items()}
        gacc, lsum = None, torch.zeros((), dtype=F32, device=device)
        for i in range(k):
            l, _, g = grads_of(params, {key: v[i] for key, v in micro.items()})
            if gacc is None:
                gacc = pytree.tree_map(
                    lambda x: None if x is None else x.to(acc_dtype), g)
            else:
                for a, b in zip(pytree.tree_leaves(gacc),
                                pytree.tree_leaves(g)):
                    if a is not None:
                        a.add_(b)
            lsum = lsum + l
            del g
        for a in pytree.tree_leaves(gacc):
            if a is not None:
                a.div_(k)
        return lsum / k, {}, _filled(gacc, params)

    def _filled(grads, params):
        return grads if layers is None else layers.fill(grads, params)

    def update(state, grads, norm_reduce=None):
        """AdamW on the state, in place -> (opt state, metrics).
        `norm_reduce` (see `adam_update`) makes the clip's norm global
        over a process group."""
        lr_scale = sched(state["opt"]["step"] + 1)
        _, opt, om = adam_update(state["params"], grads, state["opt"], adam,
                                 lr_scale, norm_reduce=norm_reduce)
        return opt, {"lr_scale": lr_scale, **om}

    def scoped(fn):
        def run(*args):
            with kpolicy.scoped(pol):
                return fn(*args)
        return run

    @scoped
    def train_step(state, batch):
        loss, parts, grads = accumulate(state["params"], batch)
        opt, om = update(state, grads)
        metrics = {"loss": loss, "lr_scale": om.pop("lr_scale"), **om}
        return {"params": state["params"], "opt": opt}, metrics | parts

    # the two halves, for timing them apart (chip_smoke.py's train phase)
    train_step.accumulate = scoped(accumulate)
    train_step.update = scoped(update)
    return train_step


def init_train_state(cfg, seed: int = 0, *, device=None,
                     max_seq: int = 4096, adam: AdamConfig | None = None,
                     shards=None):
    """{"params", "opt": {"m", "v", "step"}} on `device` (None: the GPU);
    the parameters from `init_params(cfg, seed)`. With `shards` (a
    `state_shards` tree) each leaf is this rank's shard of that state:
    the same draw, each parameter cut to its shard as it is drawn, and
    zero moments of the shards' shapes."""
    adam = adam or AdamConfig(moment_dtype=cfg.moment_dtype)
    params = init_params(cfg, seed, device=device, max_seq=max_seq,
                         shards=None if shards is None else shards["params"])
    return {"params": params, "opt": adam_init(params, adam)}


def micro_count(cfg, batch) -> int:
    """The microbatches a step cuts `batch` into: cfg.grad_accum, or one
    a row where the batch holds fewer rows (a batch rank of the (2, 16,
    16) mesh holds 8 of train_4k's 256 rows, against grad_accum 16)."""
    rows = next(iter(batch.values())).shape[0]
    return max(1, min(cfg.grad_accum, rows))


class _LayerGather:
    """The per-layer gather of `make_sharded_train_step(fsdp_gather=True)`
    (`layer_gather` of `forward`): it holds every leaf of
    ``params["blocks"]`` split over the batch axes. `forward` calls it on
    each layer's parameters inside the layer's checkpointed span; it
    gathers each held leaf whole over the batch axes
    (`collectives.gather_for_layer`; a split over "model" stays), and
    backward hands it this rank's block of the leaf's gradient, the mean
    over the batch ranks in f32, which it adds into the leaf's
    accumulator (shard-sized, in `_acc_dtype` when grad_accum > 1; at
    one rank the gradient itself, added in the accumulator's dtype).
    `start` opens a call of `accumulate` (a new token, no accumulators);
    `fill` puts the accumulators, divided by grad_accum, into the
    gradient tree."""

    def __init__(self, cfg, by_path: dict):
        self.by_path, self.k = by_path, cfg.grad_accum
        self.acc_dtype = _acc_dtype(cfg)
        self.token, self.acc, self.layers = None, {}, {}

    def held(self, path) -> bool:
        key = _path_key(path)
        return key[0] == "blocks" and self.by_path[key].sharded

    def start(self, device, k: int) -> None:
        self.token = torch.zeros((), dtype=F32, device=device,
                                 requires_grad=True)
        self.acc, self.k = {}, k

    def __call__(self, i: int, p):
        flat, spec = pytree.tree_flatten(p)
        if i not in self.layers:    # each leaf's shard and sink, once
            plan = []
            for path, _ in pytree.tree_flatten_with_path(p)[0]:
                key = ("blocks", i, *_path_key(path))
                s = self.by_path[key]
                plan.append((s, functools.partial(self._add, key))
                            if s.sharded else None)
            self.layers[i] = plan
        return pytree.tree_unflatten(
            [t if held is None else collectives.gather_for_layer(
                t, held[0].dim, held[0].group, self.token, held[1])
             for t, held in zip(flat, self.layers[i])], spec)

    def _add(self, key, block, owned: bool) -> None:
        dtype = F32 if self.k <= 1 else self.acc_dtype
        if key in self.acc:
            self.acc[key].add_(block)
        elif owned and block.dtype == dtype:
            self.acc[key] = block
        else:
            self.acc[key] = block.to(dtype, copy=True)

    def fill(self, grads, params):
        """`grads` (None at each held leaf) with the held leaves'
        gradients: f32, zeros where the loss did not read the leaf."""
        def one(path, g, p):
            if g is not None:
                return g
            acc = self.acc.pop(_path_key(path), None)
            if acc is None:
                return torch.zeros(p.shape, dtype=F32, device=p.device)
            return (acc.div_(self.k) if self.k > 1 else acc).to(F32)
        return pytree.tree_map_with_path(one, grads, params)


def make_sharded_train_step(cfg, mesh, *, rules=None,
                            adam: AdamConfig | None = None,
                            schedule_kwargs: dict | None = None, policy=None,
                            max_seq: int = 4096, fsdp_gather: bool = False):
    """The train step over `mesh` (a live DeviceMesh over ("data",
    "model") or ("pod", "data", "model"); `check_mesh` says which meshes
    and archs it takes): `train_step(state, batch) -> (state, metrics)`
    where `state` holds this rank's blocks (`state_shards`: the plan's
    spec of each leaf under `rules`, the cluster's default rules when
    None) and `batch` this rank's rows of the global batch
    (`data.Distributor`: the rows go over the batch axes, pod major, and
    every model rank of a batch row takes the same rows).

    Over the batch axes the step is data-parallel. It gathers each leaf
    split over them whole over them (`LeafShard.gather_batch`; a split
    over "model" stays), takes the local rows' loss and gradients through
    `make_train_step`'s `accumulate` (the same fused ops and autograd
    Functions, `grad_accum` micro-splitting the local rows), and reduces
    each gradient to its mean over the batch ranks in f32: by
    `reduce_scatter` to this rank's block where the leaf is split over
    the batch axes, by `all_reduce` where it is not.

    Over "model" the step is tensor-parallel: under its `ModelAxis`
    (the plan's splits, `model_axis`, passed to `loss_fn`) each rank
    computes its query and KV heads, its d_ff columns of the FFN and of
    every expert, and its vocabulary rows of the embedding and the loss,
    with Megatron's `copy_to_ranks` / `reduce_from_ranks` around each
    split computation; a dim the plan keeps whole is computed whole on
    every model rank. Every model rank then holds the same loss, and the
    gradient of each leaf it holds, whole or its block, complete.

    AdamW updates the local blocks in place, its clip reading the global
    norm: each leaf's sum of squares taken once over every distinct
    block (summed over the ranks of the axes that split it, counted once
    over those that replicate it), in one all_reduce over the mesh. The
    metrics (loss, and with grad_accum 1 its parts) are the batch ranks'
    mean. On a mesh of one rank every collective is an identity and the
    step equals `make_train_step`'s bit for bit.

    An MoE model's step is the reference's on the global batch: its
    layers dispatch over the batch ranks (`loss_fn`'s `group`)
    (capacity, slot places and the load-balance loss over every rank's
    tokens), and with grad_accum k > 1 the batch ranks first exchange
    rows (one all_gather of the batch) so that a rank's i-th microbatch
    is its block of the global batch's i-th (the reference's
    micro-split), not of its own rows. A dense model's micro-split needs
    no exchange: its mean gradient does not depend on which rows share a
    microbatch. Where a rank holds fewer rows than grad_accum
    (`micro_count`), its i-th microbatch is its i-th row: the global
    microbatch is then a row of every rank (the reference's compiler
    pads each of its grad_accum microbatches over the ranks instead, so
    an MoE model's capacity counts the tokens of other microbatches).

    Without `fsdp_gather` each leaf is gathered over the batch axes for
    the whole step and its gradient exists at that size until the step
    reduces it, so over the batch axes only the moments' memory falls
    with the ranks. With `fsdp_gather` (the reference's per-layer gather,
    `cells.build_cell(fsdp_gather=True)`) each leaf of every decoder
    layer (the reference's remainder layers too) that is split over the
    batch axes is gathered as the layer runs, inside its checkpointed
    span (under remat "nothing" the recompute gathers it again: an
    all_gather a pass), and backward reduce-scatters its gradient as it
    finishes the layer: the f32 mean over the batch ranks of this rank's
    block, added into a shard-sized accumulator for each microbatch
    (`_LayerGather`). A rank then holds one such layer whole at a time
    (all of them under remat "none", whose backward keeps what each
    layer saved, its gathered weights among it) and no whole gradient of
    one. At one rank the gather is the
    shard itself. The other leaves (the embedding, the unembedding, the
    final norm, an encoder's leaves, a layer's leaves the batch axes do
    not split) are gathered and reduced as without it. The step's state
    and metrics are those without it (bit for bit at grad_accum 1; the
    sum order of the microbatches' means differs above it).

    `train_step.shards` is the `state_shards` tree (no device),
    `.axis` the `ModelAxis`, `.gather(params)` the parameters whole and
    `.accumulate(params, batch) -> (loss, parts, grads)` the step's first
    half: this rank's mean loss and its blocks of the reduced gradients
    (what AdamW reads), `.update(state, grads) -> (opt, metrics)` the
    second, AdamW on the blocks in place, its clip reading the global
    norm."""
    if dist.get_world_size() != math.prod(addressing.mesh_axes(mesh).values()):
        raise ValueError("the sharded step's mesh must hold every rank of "
                         "the process group (its norm reduces over them)")
    rules = rules or addressing.default_rules(mesh,
                                              overrides=cfg.rules_overrides)
    shards = state_shards(cfg, mesh, rules, max_seq=max_seq)
    axis = model_axis(cfg, mesh, rules, max_seq=max_seq)
    group = addressing.batch_group(mesh)
    ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    coords = addressing.coordinates(mesh)
    first = {a: c == 0 for a, c in coords.items()}
    by_path = _by_path(shards["params"])
    layers = _LayerGather(cfg, by_path) if fsdp_gather else None
    plain = make_train_step(cfg, adam=adam, schedule_kwargs=schedule_kwargs,
                            policy=policy, axis=axis, group=group,
                            layers=layers)
    pol = kpolicy.as_policy(policy) if policy is not None else None
    k = cfg.grad_accum
    regroup = k > 1 and "attn_moe" in layer_kinds(cfg)

    def leaves_and_shards(tree):
        """The tree's leaves (in its own order), their shards, its spec."""
        flat, spec = pytree.tree_flatten_with_path(tree)
        return ([leaf for _, leaf in flat],
                [by_path[_path_key(path)] for path, _ in flat], spec)

    def gather(params, whole: bool = True):
        leaves, owners, spec = leaves_and_shards(params)
        return pytree.tree_unflatten(
            [s.gather(p) if whole else s.gather_batch(p)
             for s, p in zip(owners, leaves)], spec)

    def held(tree) -> list:
        """For each leaf of the tree: is it gathered layer by layer?"""
        return [layers is not None and layers.held(path)
                for path, _ in pytree.tree_flatten_with_path(tree)[0]]

    def gather_step(params):
        """The parameters as the step computes with them: each leaf
        gathered over the batch axes, but those gathered layer by
        layer."""
        leaves, owners, spec = leaves_and_shards(params)
        return pytree.tree_unflatten(
            [p if h else s.gather_batch(p)
             for s, p, h in zip(owners, leaves, held(params))], spec)

    def micro_rows(batch, device):
        """This rank's rows of each of the global batch's microbatches
        (`micro_count`), the microbatches one after another (from every
        rank's rows)."""
        out = {}
        n = micro_count(cfg, batch)
        for key, v in _on(device, batch).items():
            whole = collectives.all_gather_dim(v, 0, group,
                                               name="batch_all_gather")
            m = v.shape[0] // n
            rows = (torch.arange(n, device=device)[:, None] * ranks * m
                    + rank * m + torch.arange(m, device=device)).reshape(-1)
            out[key] = whole[rows]
        return out

    def reduce_leaves(leaves, owners, spec, done):
        """`leaves` (a list this function empties as it goes, so each
        gathered gradient is freed once reduced) -> the tree of means over
        the batch ranks; a leaf `done` marks is that mean already."""
        out = []
        for i, s in enumerate(owners):
            g = leaves[i].to(F32)
            leaves[i] = None
            if done[i]:
                out.append(g)
                continue
            if s.sharded:
                g = collectives.reduce_scatter_dim(g, s.dim, group)
            else:
                g = collectives.all_reduce(g, group)
            out.append(g.div_(ranks))
        return pytree.tree_unflatten(out, spec)

    def norm_reduce(owners: list):
        """`adam_update`'s `norm_reduce`: each leaf's sum of squares over
        its distinct blocks. A rank adds its block's sum where it is the
        first rank (coordinate 0) of every axis group that holds the same
        block: of the batch axes unless the leaf is split over them, of
        "model" unless it is split over it; one all_reduce over the mesh
        then sums each distinct block once."""
        lead = [(s.sharded or all(first.get(a, True)
                                  for a in addressing.BATCH_AXES))
                and (s.model_sharded or first.get("model", True))
                for s in owners]

        def run(sums):
            mask = torch.tensor(lead, dtype=sums.dtype, device=sums.device)
            return collectives.all_reduce(sums * mask, dist.group.WORLD)
        return run

    def mean_metrics(metrics: dict) -> dict:
        keys = list(metrics)
        flat = collectives.all_reduce(
            torch.stack([metrics[k].to(F32) for k in keys]), group)
        return dict(zip(keys, flat.div_(ranks).unbind()))

    def accumulate(params, batch):
        with kpolicy.scoped(pol):
            full = gather_step(params)
            if regroup:
                batch = micro_rows(batch, pytree.tree_leaves(full)[0].device)
            loss, parts, grads = plain.accumulate(full, batch)
            del full
            leaves, owners, spec = leaves_and_shards(grads)
            done = held(grads)
            del grads
            return loss, parts, reduce_leaves(leaves, owners, spec, done)

    def update(state, grads):
        with kpolicy.scoped(pol):
            return plain.update(state, grads, norm_reduce(
                leaves_and_shards(grads)[1]))

    def train_step(state, batch):
        loss, parts, grads = accumulate(state["params"], batch)
        opt, om = update(state, grads)
        with kpolicy.scoped(pol):
            means = mean_metrics({"loss": loss, **parts})
        metrics = {"loss": means.pop("loss"),
                   "lr_scale": om.pop("lr_scale"), **om}
        return {"params": state["params"], "opt": opt}, metrics | means

    train_step.shards = shards
    train_step.axis = axis
    train_step.gather = gather
    train_step.accumulate = accumulate
    train_step.update = update
    return train_step


def _greedy(lg, axis: ModelAxis | None):
    """(B,) int64 greedy tokens of f32 logits (B, V), or of this rank's
    vocabulary block of them where `axis` splits the vocabulary: the
    global argmax, the largest value over the ranks and on a tie the
    lowest index, as `torch.argmax` picks it
    (`collectives.argmax_over_ranks`)."""
    if axis is None or axis.vocab is None:
        return torch.argmax(lg, dim=-1)
    return collectives.argmax_over_ranks(
        lg.amax(dim=-1), torch.argmax(lg, dim=-1) + axis.vocab.start,
        axis.group)


def make_prefill_step(cfg, *, policy=None, axis: ModelAxis | None = None,
                      group=None) -> Graphed:
    """`prefill_step(params, batch) -> (B,) int32` greedy next tokens.
    `batch["enc_embeds"]` (or "img_embeds") is the cross context.
    `policy` pins the kernel policy (None -> the ambient one).

    `axis` and `group` are the sharded prefill's (`make_sharded_prefill_
    step`): the blocks compute this rank's splits, the embedding is the
    masked lookup of its vocabulary rows, the logits are its vocabulary
    block and the token their global argmax (`_greedy`); MoE layers
    dispatch over the batch ranks' tokens.

    On CUDA inputs the step runs as captured CUDA graphs (`Graphed`), one
    per key: the batch's shapes and dtypes and the identity of the
    parameter tensors. The first call with a key runs eagerly and
    captures; later calls copy the batch into the graph's inputs and
    replay, and return a fresh token tensor. The graphs (`.graphs`) are
    the step's own and go with it; `.eager` is the step run from Python.
    CPU inputs, and a step with `axis` or `group` (its collectives),
    run eagerly."""
    pol = kpolicy.as_policy(policy) if policy is not None else None

    @torch.inference_mode()
    def prefill_step(params, batch):
        with kpolicy.scoped(pol):
            cross = batch.get("enc_embeds", batch.get("img_embeds"))
            hidden, _ = forward(cfg, params, batch["tokens"],
                                cross_embeds=cross, axis=axis, group=group)
            lg = logits(params, hidden[:, -1])
            return _greedy(lg, axis).to(torch.int32)

    return Graphed(prefill_step, copied=(1,),
                   cuda_graph=axis is None and group is None)


def make_decode_step(cfg, max_seq: int = 1 << 30, *, policy=None,
                     axis: ModelAxis | None = None, group=None):
    """`decode_step(params, cache, batch) -> (cache, token (B, 1) int32)`.

    `batch["pos"]` is an int (all slots at one position) or a (B,) tensor
    (per-slot positions, the continuous-batching session); a
    ``batch["pages"]`` (B, pages_per_slot) table routes K/V through the
    paged pool. The cache is updated in place. An encoder-decoder model
    adds its learned position `dec_pos[pos]` and takes no rope.

    `axis` (a `ModelAxis` with its `CacheSplit`) and `group` (the batch
    ranks' group where the plan splits the slots) are the sharded decode
    step's (`make_sharded_decode_step`): the cache holds this rank's
    blocks, the attention kinds compute their splits
    (`blocks._split_attention_decode`), MoE layers dispatch over every
    batch rank's slots, a paged pool takes every batch rank's writes,
    and the token is the global argmax of the vocabulary blocks."""
    pol = kpolicy.as_policy(policy) if policy is not None else None
    kinds = layer_kinds(cfg)
    slots = layer_caches(cfg)
    encdec = cfg.family == "encdec"

    @torch.inference_mode()
    def decode_step(params, cache, batch):
        with kpolicy.scoped(pol):
            tokens = batch["tokens"]
            B = tokens.shape[0]
            pos = batch["pos"]
            if isinstance(pos, numbers.Integral):
                # filled on the device: a graph capture takes no host copy
                pos = torch.full((), int(pos), dtype=torch.int64,
                                 device=tokens.device)
            else:
                pos = torch.as_tensor(pos, device=tokens.device)
            x = _embed(params["tok_embed"], tokens, axis)          # (B,1,d)
            positions = (pos.expand(B) if pos.ndim == 0 else pos)[:, None]
            if encdec:
                x = x + params["dec_pos"][positions.long()].to(x.dtype)
            ctx = {"positions": positions, "rope": not encdec,
                   "max_seq": max_seq, "pages": batch.get("pages"),
                   "model_axis": axis, "dispatch_group": group,
                   "pool_group": group}
            for kind, p, (keys, j) in zip(kinds, params["blocks"], slots):
                layer_cache = {k: cache[key][j] for k, key in keys.items()}
                x, _ = BLOCKS[kind]["decode"](cfg, p, x, layer_cache, pos,
                                              ctx)
            x = _final_norm(cfg, params, x)
            lg = logits(params, x[:, 0])
            return cache, _greedy(lg, axis).to(torch.int32)[:, None]

    return decode_step


def _serve_parts(cfg, mesh, rules, max_seq: int, batch: int | None):
    """(rules, parameter shards, ModelAxis, the batch ranks' group where
    the plan splits `batch` rows over the batch axes (None: whole on
    every rank; `batch` None: split), the parameters' gather) of a
    sharded serving step."""
    rules = rules or addressing.default_rules(mesh,
                                              overrides=cfg.rules_overrides)
    shards = state_shards(cfg, mesh, rules, max_seq=max_seq)["params"]
    axis = model_axis(cfg, mesh, rules, max_seq=max_seq)
    sizes = addressing.mesh_axes(mesh)
    ranks = math.prod(sizes[a] for a in addressing.BATCH_AXES if a in sizes)
    spec = rules.spec_for(("batch",), (ranks if batch is None else batch,),
                          mesh)
    group = addressing.batch_group(mesh) if spec else None
    return rules, shards, axis, group, _batch_gather(shards, mesh)


def _batch_gather(shards, mesh):
    """`gather(params)`: the parameters whole over the batch axes (each
    leaf's "embed" block under fsdp gathered, `LeafShard.gather_batch`; a
    split over "model" stays), gathered once per parameter tree (the
    same leaf tensors, held by the memo) and kept for the cell's later
    calls; where the batch axes have one rank a rank's blocks are whole
    over them already, and nothing is gathered or copied. A rank then
    holds its model blocks whole over the batch axes: for qwen3-14b's
    bf16 parameters 7.38 GB on (2, 4) (3.89 GB sharded; 3.49 GB moved
    once) and 6.57 GB on (16, 16) (0.50 GB sharded), where a gather
    every call would move those bytes again each step."""
    by_path = _by_path(shards)
    one_rank = dist.get_world_size(addressing.batch_group(mesh)) == 1
    memo: dict = {}

    def gather(params):
        if one_rank:
            return params
        flat, spec = pytree.tree_flatten_with_path(params)
        leaves = [leaf for _, leaf in flat]
        held = memo.get("leaves")
        if held is not None and len(held) == len(leaves) and all(
                a is b for a, b in zip(held, leaves)):
            return memo["tree"]
        memo.clear()
        tree = pytree.tree_unflatten(
            [by_path[_path_key(path)].gather_batch(leaf)
             for path, leaf in flat], spec)
        memo.update(leaves=leaves, tree=tree)
        return tree

    return gather


def make_sharded_prefill_step(cfg, mesh, *, rules=None, policy=None,
                              max_seq: int = 4096, batch: int | None = None):
    """The prefill step over a live (data, model) or (pod, data, model)
    mesh (`check_mesh`): `prefill_step(params, batch) -> (B_rank,) int32`
    with `params` this rank's blocks (`.shards`, the train step's
    `state_shards` of the parameters) and `batch` its rows of the global
    batch (the plan's batch block; `batch`, the global row count, says
    whether the plan splits it: None, a multiple of the batch ranks).

    Each leaf split over the batch axes (fsdp's "embed") is gathered over
    them once per parameter tree (`_batch_gather`; the gathered tree is
    kept for later calls: a rank then holds its model blocks whole over
    the batch axes, what the step reads every call, where gathering
    every call would move them again each time); over "model" the rank
    computes its splits as the train step's forward does (`ModelAxis`:
    row 1 at N = heads / model and d_ff / model, row 3 at the rank's
    heads, row 2 on the row-parallel partials), its vocabulary block of
    the logits and their global argmax. Eager (no CUDA graph: the
    collectives run between the kernels). At one rank the tokens equal
    `make_prefill_step`'s bit for bit."""
    rules, shards, axis, group, gather = _serve_parts(cfg, mesh, rules,
                                                      max_seq, batch)
    inner = make_prefill_step(cfg, policy=policy, axis=axis, group=group)

    def prefill_step(params, batch):
        return inner(gather(params), batch)

    prefill_step.shards, prefill_step.axis = shards, axis
    prefill_step.group, prefill_step.gather = group, gather
    return prefill_step


def make_sharded_decode_step(cfg, mesh, max_seq: int, *, rules=None,
                             policy=None, batch: int | None = None):
    """The decode step over a live mesh: `decode_step(params, cache,
    batch) -> (cache, token (B_rank, 1) int32)` with this rank's
    parameter blocks (`.shards`), its blocks of the cache
    (`cache_shards` at the same `batch` and `decode_cache_len(cfg,
    max_seq)`; paged or private) and its rows of
    the tokens, positions and page tables.

    The parameters' batch-axis blocks are gathered once per parameter
    tree, as the sharded prefill's. Over "model" the rank computes its
    query heads, its KV heads, its d_ff columns of the FFN or of every
    expert and its vocabulary block (`ModelAxis`), and its block of the
    cache as the plan places it (`CacheSplit`, `.split`): kv_seq split
    over "model" (each rank writes the rows that fall in its block and
    attends over them; the blocks combine by log-sum-exp), else kv_heads
    (the pool, or a cache whose rows the model size does not divide:
    each rank its heads' rows), else whole. See
    `blocks._split_attention_decode` for the collectives of a layer. The
    step is eager (a chunk of it on a mesh is not captured as a CUDA
    graph: ROADMAP Queue 1, Later). At one rank it equals
    `make_decode_step`'s bit for bit."""
    rules, shards, axis, group, gather = _serve_parts(cfg, mesh, rules,
                                                      max_seq, batch)
    split = cache_split(cfg, mesh, rules, decode_cache_len(cfg, max_seq))
    if axis is not None:
        kv = any("kv_heads" in s.logical
                 for s in cache_specs(cfg, 1, 1).values())
        for held in (split.heads, split.cross_heads) if kv else ():
            if held is not None and held != axis.kv_heads:
                raise NotImplementedError(
                    f"the plan splits the cache's KV heads {held} and the "
                    f"parameters' {axis.kv_heads} differently")
        axis = dataclasses.replace(axis, cache=split)
    inner = make_decode_step(cfg, max_seq, policy=policy, axis=axis,
                             group=group)

    def decode_step(params, cache, batch):
        return inner(gather(params), cache, batch)

    decode_step.shards, decode_step.axis = shards, axis
    decode_step.group, decode_step.gather = group, gather
    decode_step.split = split
    return decode_step


def make_decode_chunk(cfg, chunk: int, max_seq: int = 1 << 30, *,
                      eos_id: int | None = None, policy=None):
    """The K-token decode program (the execution engine's entry):
    `make_decode_step` rolled into `chunk` steps with on-device EOS
    masking, one CUDA graph on the card. See
    `runtime/engine.make_decode_chunk` for the calling convention."""
    from repro_torch.runtime import engine
    step = make_decode_step(cfg, max_seq=max_seq, policy=policy)
    return engine.make_decode_chunk(step, chunk, eos_id=eos_id)

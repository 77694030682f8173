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
"""

from __future__ import annotations

import functools
import math
import numbers

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.cluster import policy as kpolicy
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.blocks import BLOCKS, _norm, _norm_specs
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
# recompute nothing. The reference's "dots" / "dots_no_batch" (save the
# products' outputs) have no port yet.
REMAT = ("nothing", "none", "everything")


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


def _materialize(tree, generator, device):
    if isinstance(tree, ParamSpec):
        return tree.materialize(generator, device)
    if isinstance(tree, dict):
        return {k: _materialize(tree[k], generator, device)
                for k in sorted(tree)}
    return [_materialize(t, generator, device) for t in tree]


def init_params(cfg, seed: int = 0, *, device=None, max_seq: int = 4096):
    """Random parameters drawn on `device` (None: the GPU) from a seeded
    torch.Generator (the port cannot recreate the reference's jax.random
    streams; tests load the reference's parameters through
    `weights.from_jax_params`)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _materialize(param_specs(cfg, max_seq), gen, device)


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


def _zeros(specs: dict, device) -> dict:
    device = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in specs.items()}


def init_cache(cfg, B: int, cache_len: int, *, device=None):
    return _zeros(cache_specs(cfg, B, cache_len), device)


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
                     page_size: int, device=None):
    return _zeros(paged_cache_specs(cfg, B, cache_len, n_pages=n_pages,
                                    page_size=page_size), device)


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


def _remat(cfg) -> bool:
    """Does forward recompute each layer in backward? Only under grad, and
    only for cfg.remat "nothing" (see REMAT)."""
    if not torch.is_grad_enabled():
        return False
    if cfg.remat not in REMAT:
        raise NotImplementedError(
            f"remat policy {cfg.remat!r}: the port takes {REMAT}; the "
            f"selective policies wait in ROADMAP Queue 1 (after H)")
    return cfg.remat == "nothing"


def _layer(remat: bool, apply, *args):
    """One layer, `apply(*args)`: under `remat`, only its inputs are kept
    and backward runs it again (the policy scope of the step is still
    active then, so the recompute takes the same kernels)."""
    if remat:
        return checkpoint(apply, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return apply(*args)


def _encode(cfg, params, enc_embeds):
    """Whisper's encoder over stub frame embeddings (B, enc_seq, d)."""
    enc = params["enc"]
    x = enc_embeds + enc["pos"].to(enc_embeds.dtype)
    B, S = x.shape[:2]
    ctx = {"positions": torch.arange(S, device=x.device).expand(B, S),
           "rope": False}
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
    if hidden.is_cuda and hidden.dtype == w.dtype == torch.bfloat16:
        return product("...d,dv->...v", hidden, w, F32)
    return hidden.to(F32) @ w.to(F32)


def forward(cfg, params, tokens, *, cross_embeds=None):
    """Token ids (B, S) -> final hidden states (B, S, d) and aux loss. An
    encoder-decoder model encodes `cross_embeds` (its stub frame
    embeddings) first and adds its learned decoder positions; a vision
    model's cross blocks take `cross_embeds` (its image embeddings) as
    they come."""
    kinds = layer_kinds(cfg)
    B, S = tokens.shape
    x = params["tok_embed"][tokens.long()]
    encdec = cfg.family == "encdec"
    if encdec:
        cross_embeds = _encode(cfg, params, cross_embeds)
        x = x + params["dec_pos"][:S].to(x.dtype)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    ctx = {"positions": positions, "rope": not encdec,
           "cross_embeds": cross_embeds, "max_seq": S}
    aux = 0.0
    remat = _remat(cfg)
    for kind, p in zip(kinds, params["blocks"]):
        x, a = _layer(remat, BLOCKS[kind]["apply"], cfg, p, x, ctx)
        aux = aux + a
    return _final_norm(cfg, params, x), aux


# ----------------------------------------------------------------------------
# Loss (chunked over the sequence; the logits never exist at (B, S, V))
# ----------------------------------------------------------------------------

def _ce_block(unembed, h, y):
    """One chunk's summed NLL and z-loss; h (B, c, d), y (B, c)."""
    lg = logits({"unembed": unembed}, h)                   # (B, c, V) f32
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, y.long()[..., None])[..., 0]
    return (lse - ll).sum(), Z_COEF * torch.square(lse).sum()


def _chunked_ce(cfg, unembed, hidden, labels):
    """Mean cross-entropy plus z-loss over (B, S), LOSS_CHUNK positions at
    a time (S when S is not a multiple). Under grad each chunk is
    recomputed in backward, so one chunk's f32 logits are all that ever
    exists (the reference's `jax.checkpoint` scan body)."""
    B, S, _ = hidden.shape
    c = min(LOSS_CHUNK, S)
    if S % c:
        c = S
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(S // c):
        cols = slice(i * c, (i + 1) * c)
        nll, z = _layer(remat, _ce_block, unembed, hidden[:, cols],
                        labels[:, cols])
        total = total + nll + z
    return total / (B * S)


def loss_fn(cfg, params, batch):
    """(loss, {"ce", "aux"}) of one batch: the chunked CE plus AUX_COEF x
    the MoE load-balance loss (0 without MoE layers)."""
    cross = batch.get("enc_embeds", batch.get("img_embeds"))
    hidden, aux = forward(cfg, params, batch["tokens"], cross_embeds=cross)
    ce = _chunked_ce(cfg, params["unembed"], hidden, batch["labels"])
    aux = torch.as_tensor(aux, device=ce.device).to(F32)
    return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------------------
# Train step
# ----------------------------------------------------------------------------

def _on(device, batch: dict) -> dict:
    """The batch's arrays as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg, *, adam: AdamConfig | None = None,
                    schedule_kwargs: dict | None = None, policy=None):
    """`train_step(state, batch) -> (state, metrics)`, the state updated
    in place (the reference donates it). `policy` pins the kernel policy
    (None -> the ambient one); its scope covers the forward and the
    backward, so a recomputed layer takes the forward's kernels.

    With cfg.grad_accum = k > 1 the batch is cut into k microbatches along
    its rows, each one's gradients taken with `torch.autograd.grad` and
    added into an accumulator of `acc_dtype` (f32, bf16 when the moments
    are bf16), which is divided by k: the metrics are the mean loss, the
    learning-rate scale and the gradient norm. With k = 1 the metrics also
    hold the loss's parts ("ce", "aux"). Metrics are 0-d tensors on the
    device; nothing is read back to the host. The step's halves are
    `train_step.accumulate(params, batch) -> (loss, parts, grads)` and
    `train_step.update(state, grads) -> (opt, metrics)`, each in the
    policy's scope."""
    pol = kpolicy.as_policy(policy) if policy is not None else None
    adam = adam or AdamConfig(moment_dtype=cfg.moment_dtype)
    sched = functools.partial(warmup_cosine, **(schedule_kwargs or {}))
    acc_dtype = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else F32

    def grads_of(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss, parts = loss_fn(cfg, pytree.tree_unflatten(live, spec), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                pytree.tree_unflatten(list(grads), spec))

    def accumulate(params, batch):
        """(loss, parts, grads) of the batch, over its k microbatches."""
        batch = _on(pytree.tree_leaves(params)[0].device, batch)
        k = cfg.grad_accum
        if k <= 1:
            return grads_of(params, batch)
        micro = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])
                 for key, v in batch.items()}
        gacc, lsum = None, torch.zeros((), dtype=F32,
                                       device=batch["tokens"].device)
        for i in range(k):
            l, _, g = grads_of(params, {key: v[i] for key, v in micro.items()})
            if gacc is None:
                gacc = pytree.tree_map(lambda x: x.to(acc_dtype), g)
            else:
                for a, b in zip(pytree.tree_leaves(gacc),
                                pytree.tree_leaves(g)):
                    a.add_(b)
            lsum = lsum + l
            del g
        for a in pytree.tree_leaves(gacc):
            a.div_(k)
        return lsum / k, {}, gacc

    def update(state, grads):
        """AdamW on the state, in place -> (opt state, metrics)."""
        lr_scale = sched(state["opt"]["step"] + 1)
        _, opt, om = adam_update(state["params"], grads, state["opt"], adam,
                                 lr_scale)
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
                     max_seq: int = 4096, adam: AdamConfig | None = None):
    """{"params", "opt": {"m", "v", "step"}} on `device` (None: the GPU);
    the parameters from `init_params(cfg, seed)`."""
    adam = adam or AdamConfig(moment_dtype=cfg.moment_dtype)
    params = init_params(cfg, seed, device=device, max_seq=max_seq)
    return {"params": params, "opt": adam_init(params, adam)}


def make_prefill_step(cfg, *, policy=None) -> Graphed:
    """`prefill_step(params, batch) -> (B,) int32` greedy next tokens.
    `batch["enc_embeds"]` (or "img_embeds") is the cross context.
    `policy` pins the kernel policy (None -> the ambient one).

    On CUDA inputs the step runs as captured CUDA graphs (`Graphed`), one
    per key: the batch's shapes and dtypes and the identity of the
    parameter tensors. The first call with a key runs eagerly and
    captures; later calls copy the batch into the graph's inputs and
    replay, and return a fresh token tensor. The graphs (`.graphs`) are
    the step's own and go with it; `.eager` is the step run from Python.
    CPU inputs run eagerly."""
    pol = kpolicy.as_policy(policy) if policy is not None else None

    @torch.inference_mode()
    def prefill_step(params, batch):
        with kpolicy.scoped(pol):
            cross = batch.get("enc_embeds", batch.get("img_embeds"))
            hidden, _ = forward(cfg, params, batch["tokens"],
                                cross_embeds=cross)
            lg = logits(params, hidden[:, -1])
            return torch.argmax(lg, dim=-1).to(torch.int32)

    return Graphed(prefill_step, copied=(1,))


def make_decode_step(cfg, max_seq: int = 1 << 30, *, policy=None):
    """`decode_step(params, cache, batch) -> (cache, token (B, 1) int32)`.

    `batch["pos"]` is an int (all slots at one position) or a (B,) tensor
    (per-slot positions, the continuous-batching session); a
    ``batch["pages"]`` (B, pages_per_slot) table routes K/V through the
    paged pool. The cache is updated in place. An encoder-decoder model
    adds its learned position `dec_pos[pos]` and takes no rope."""
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
            x = params["tok_embed"][tokens.long()]                # (B,1,d)
            positions = (pos.expand(B) if pos.ndim == 0 else pos)[:, None]
            if encdec:
                x = x + params["dec_pos"][positions.long()].to(x.dtype)
            ctx = {"positions": positions, "rope": not encdec,
                   "max_seq": max_seq, "pages": batch.get("pages")}
            for kind, p, (keys, j) in zip(kinds, params["blocks"], slots):
                layer_cache = {k: cache[key][j] for k, key in keys.items()}
                x, _ = BLOCKS[kind]["decode"](cfg, p, x, layer_cache, pos,
                                              ctx)
            x = _final_norm(cfg, params, x)
            lg = logits(params, x[:, 0])
            token = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
            return cache, token

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

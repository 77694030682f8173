"""The collectives of the sharded train step, each counted where it is
issued.

`all_gather_dim` makes a whole leaf from every rank's chunk along a dim,
`reduce_scatter_dim` sums a whole gradient over the ranks and hands each
its chunk, `all_reduce` sums a tensor over the ranks in place, and
`sum_over_ranks` is that sum as an autograd function (its backward sums
the gradient over the ranks in turn: the MoE dispatch's load-balance
sums over the batch axes, which every rank's loss reads).
`gather_for_layer` is the per-layer gather of the train step
(`fsdp_gather`): an all_gather forward and, backward, a reduce_scatter
of the gradient whose f32 block goes to the caller's accumulator.

The model axis has Megatron's two conjugate operators. `copy_to_ranks`
is the identity forward and an all-reduce of the gradient backward: it
stands where a value every model rank holds whole enters a computation
split over the ranks (a column-parallel product's input, a norm scale
read inside it), whose gradient each rank then holds only a part of.
`reduce_from_ranks` is an all-reduce forward and the identity backward:
it sums the ranks' partial outputs (a row-parallel product's) into the
whole value. `max_over_ranks` is a max with no gradient (the
vocab-parallel loss's). `scatter_from_ranks` is a reduce-scatter forward
and an all-gather of the gradient backward: a product split on its
input channels (the RG-LRU's gates) sums its partials and each rank
keeps its own output channels. `gather_from_ranks` is its conjugate, an
all-gather forward and a reduce-scatter of the gradient backward: a
product split on its output channels whose whole output each rank reads
in part (xlstm's w_up and w_in columns).

Serving on a mesh runs under `inference_mode` and uses the plain forms:
`all_gather_dim` of the query heads and the new K/V rows
(``heads_all_gather``), the log-sum-exp combine of a decode split over
the cache's rows (`attention.combine_blocks`: ``lse_max``, then
``lse_sum`` and ``lse_out``), the paged pool's writes shared over the
batch ranks (``pool_all_gather``) and `argmax_over_ranks`, the greedy
token of vocab-parallel logits (``argmax_all_gather``); with gradients
off, `copy_to_ranks` and `reduce_from_ranks` take their forwards
without an autograd Function. `sum_over_ranks` is not used on the model
axis: every model rank holds the same replica of the loss, so summing
its gradient over them would multiply it by the model size.

Each takes the process group it runs on: there is no default group. On
a group of one rank (a model axis of 1, a data-only mesh's model
groups, a one-rank mesh) the result is the rank's own tensor, so the
backend is not called: the call returns its input (an in-place sum, a
max of a copy) or a copy of it (where it returns a new tensor). A
one-rank NCCL call still costs the host its dispatch
(`tools/mesh_trace.py` times it), which a decode step's ~240 would pay
for nothing.

`counts()` holds the calls made since `reset_counts()`, by name, and the
bytes each call's whole tensor holds (``<name>_bytes``). A call counts
under its collective's name unless its caller names it otherwise (the
MoE dispatch's counts under ``dispatch_*``, the step's exchange of batch
rows under ``batch_all_gather``). Inside `ledger()` each call is also
recorded as a `Call`: its kind by the reference's names ("all-gather",
"reduce-scatter", "all-reduce"), its result's bytes and its group's
ranks, which a dry run (`core/op_cost.py`, `core/locality.py`) prices.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Iterator

import torch
import torch.distributed as dist

NAMES = ("all_gather", "reduce_scatter", "all_reduce", "copy_to_ranks",
         "reduce_from_ranks", "max_over_ranks", "gates_reduce_scatter",
         "gates_all_gather", "inner_all_gather", "inner_reduce_scatter")
# the serving collectives (counted by these names where they are issued)
SERVE_NAMES = ("heads_all_gather", "lse_max", "lse_sum", "lse_out",
               "pool_all_gather", "argmax_all_gather", "steps_max")

_COUNTS: collections.Counter = collections.Counter()
_LEDGERS: list[list] = []


@dataclasses.dataclass(frozen=True)
class Call:
    """One collective call: its counted name, its kind, the bytes of its
    result on this rank and the global ranks of its group."""
    name: str
    kind: str
    result_bytes: int
    ranks: tuple


@contextlib.contextmanager
def ledger() -> Iterator[list]:
    """A list that every collective issued inside the block appends its
    `Call` to."""
    calls: list = []
    _LEDGERS.append(calls)
    try:
        yield calls
    finally:
        _LEDGERS.remove(calls)


def reset_counts() -> None:
    _COUNTS.clear()


def counts() -> dict[str, int]:
    names = NAMES + SERVE_NAMES
    out = {n: 0 for n in names} | {f"{n}_bytes": 0 for n in names}
    return out | dict(_COUNTS)


def _count(name: str, whole: torch.Tensor, group, kind: str,
           itemsize: int | None = None) -> None:
    """One call of `name` (a collective of `kind` over `group`) on a whole
    tensor like `whole` (of `itemsize` bytes an element when given)."""
    nbytes = whole.numel() * (itemsize or whole.element_size())
    _COUNTS[name] += 1
    _COUNTS[f"{name}_bytes"] += nbytes
    if _LEDGERS:
        ranks = tuple(dist.get_process_group_ranks(group))
        if kind == "reduce-scatter":
            nbytes //= len(ranks)
        call = Call(name, kind, nbytes, ranks)
        for calls in _LEDGERS:
            calls.append(call)


def _need(group):
    if group is None:
        raise ValueError("a collective needs its process group")
    return group


def _alone(group) -> bool:
    """Is `group` one rank (its collectives known without the backend)?"""
    return dist.get_world_size(group) == 1


# torch 2.13 names the flat collectives *_single (the *_tensor names
# warn there); earlier releases have only the *_tensor names
_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_gather_dim(local: torch.Tensor, dim: int, group, *,
                   name: str = "all_gather") -> torch.Tensor:
    """Every rank's `local` concatenated along `dim` in rank order (a new
    tensor)."""
    group = _need(group)
    n = dist.get_world_size(group)
    if n == 1:
        _count(name, local, group, "all-gather")
        return local.clone(memory_format=torch.contiguous_format)
    front = local.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0], *front.shape[1:]),
                      dtype=local.dtype, device=local.device)
    _count(name, out, group, "all-gather")
    _GATHER(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(whole: torch.Tensor, dim: int, group, *,
                       name: str = "reduce_scatter") -> torch.Tensor:
    """The sum over the ranks of `whole`, cut along `dim` into one chunk a
    rank: this rank's chunk (a new tensor)."""
    group = _need(group)
    n = dist.get_world_size(group)
    if n == 1:
        _count(name, whole, group, "reduce-scatter")
        return whole.clone(memory_format=torch.contiguous_format)
    front = whole.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n, *front.shape[1:]),
                      dtype=whole.dtype, device=whole.device)
    _count(name, front, group, "reduce-scatter")
    _SCATTER(out, front, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, group, *,
               name: str = "all_reduce") -> torch.Tensor:
    """The sum of `t` over the ranks, in place."""
    group = _need(group)
    _count(name, t, group, "all-reduce")
    if not _alone(group):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, name):
        ctx.group, ctx.name = group, name
        return all_reduce(t.clone(), group, name=name)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group, name=ctx.name), None, None


def sum_over_ranks(t: torch.Tensor, group, *,
                   name: str = "all_reduce") -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor), differentiable: when
    every rank's loss reads the sum, the gradient of `t` on a rank is the
    sum of the ranks' gradients of the sum."""
    return _SumOverRanks.apply(t, _need(group), name)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` (a collective writes its result into it)."""
    return t.clone(memory_format=torch.contiguous_format)


class _CopyToRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(_dense(grad), ctx.group, name="copy_to_ranks"), None


class _ReduceFromRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(_dense(t), group, name="reduce_from_ranks")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterFromRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(t, dim, group, name="gates_reduce_scatter")

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.dim, ctx.group,
                              name="gates_all_gather"), None, None


class _GatherFromRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(t, dim, group, name="inner_all_gather")

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group,
                                  name="inner_reduce_scatter"), None, None


class _GatherForLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, shard, dim, group, sink):
        ctx.dim, ctx.group, ctx.sink = dim, group, sink
        if _alone(group):
            _count("all_gather", shard, group, "all-gather")
            return shard                    # a view of the shard: no copy
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        if n == 1:                  # the mean is the gradient itself
            _count("reduce_scatter", grad, ctx.group, "reduce-scatter",
                   itemsize=4)
            ctx.sink(grad, False)
        else:
            ctx.sink(reduce_scatter_dim(grad.to(torch.float32), ctx.dim,
                                        ctx.group).div_(n), True)
        return None, None, None, None, None


def gather_for_layer(shard: torch.Tensor, dim: int, group, token, sink):
    """The per-layer gather of the sharded train step: forward, every
    rank's `shard` concatenated along `dim` (`all_gather_dim`; at one
    rank the shard itself, not a copy); backward, this rank's block of
    the mean over the ranks of the gradient, reduced in f32
    (`reduce_scatter_dim`, then divided by the ranks), handed to
    `sink(block, owned)` and not returned: autograd would round it to the
    shard's dtype. At one rank the block is the gradient itself, in its
    own dtype and not `owned` (autograd's buffer: the sink adds it in
    f32 or copies it). The shard takes no gradient; `token` (a 0-d
    tensor that requires grad, which the caller differentiates the loss
    by) puts the gather on the backward's path."""
    return _GatherForLayer.apply(token, shard, dim, _need(group), sink)


def copy_to_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """`t` itself forward; backward, the sum over the ranks of its
    gradient (counted as ``copy_to_ranks`` when backward issues it)."""
    group = _need(group)
    if not torch.is_grad_enabled():
        return t
    return _CopyToRanks.apply(t, group)


def reduce_from_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor); backward, the
    gradient as it is, on every rank."""
    group = _need(group)
    if not torch.is_grad_enabled():
        return all_reduce(_dense(t), group, name="reduce_from_ranks")
    return _ReduceFromRanks.apply(t, group)


def scatter_from_ranks(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the ranks of `t`, each rank's partial of a whole
    value, cut along `dim`: this rank's chunk (a new tensor; counted as
    ``gates_reduce_scatter``). Backward, every rank's chunk of the
    gradient gathered along `dim` (``gates_all_gather``): each rank's
    partial reads every chunk of the sum, whose gradients the other
    ranks hold. The RG-LRU's gate products, split on their input
    channels, take it, and xlstm's q / k / v and gate products where the
    model size divides its heads."""
    group = _need(group)
    if not torch.is_grad_enabled():
        return reduce_scatter_dim(t, dim % t.ndim, group,
                                  name="gates_reduce_scatter")
    return _ScatterFromRanks.apply(t, dim % t.ndim, group)


def gather_from_ranks(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` (a new tensor; counted as
    ``inner_all_gather``), each rank's columns of a column-parallel
    product made whole. Backward, the gradient summed over the ranks and
    cut along `dim` (``inner_reduce_scatter``): each rank reads only some
    columns of the whole, and the columns it computed take every rank's
    share. xlstm's w_up and w_in outputs take it (`scatter_from_ranks`'
    conjugate)."""
    group = _need(group)
    if not torch.is_grad_enabled():
        return all_gather_dim(t, dim % t.ndim, group,
                              name="inner_all_gather")
    return _GatherFromRanks.apply(t, dim % t.ndim, group)


def max_over_ranks(t: torch.Tensor, group, *,
                   name: str = "max_over_ranks") -> torch.Tensor:
    """The elementwise max of `t` over the ranks (a new tensor, no
    gradient)."""
    group = _need(group)
    out = _dense(t.detach())
    _count(name, out, group, "all-reduce")
    if not _alone(group):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def argmax_over_ranks(values: torch.Tensor, index: torch.Tensor,
                      group) -> torch.Tensor:
    """The global argmax of logits split over the ranks by their last
    dim, from each rank's local max `values` (B,) f32 and its global
    index `index` (B,): one all_gather of both (exact in float64), then on
    every rank the largest value and, on a tie, the lowest rank's index,
    which is the lowest index when the ranks hold ascending blocks (as
    `torch.argmax` picks the first of equal maxima)."""
    pair = torch.stack([values.to(torch.float64), index.to(torch.float64)])
    every = all_gather_dim(pair[None], 0, group, name="argmax_all_gather")
    best = torch.argmax(every[:, 0], dim=0)                  # first max
    return every[:, 1].gather(0, best[None])[0].to(index.dtype)

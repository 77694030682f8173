"""The selective remat policies of cfg.remat "dots" and "dots_no_batch"
(the reference's `jax.checkpoint_policies.checkpoint_dots` and
`checkpoint_dots_with_no_batch_dims`, `repro.core.overlap._policy`).

A layer under one of them runs inside `torch.utils.checkpoint` with
`create_selective_checkpoint_contexts(policy(name))` (`models/steps._layer`):
its forward keeps the outputs of the products the policy names, and
backward runs the layer again, every other op recomputed (norms, RoPE,
casts, elementwise passes, the collectives, on every rank alike) and
every kept product's output read back in place of its `mm` / `bmm`.

The policy cannot tell a product from the aten op alone: on the CPU
every two-operand einsum is a `bmm`, with or without a batch index, and
a fused kernel's plain version issues its own `mm`s. So products are
marked where they are made. `models/layers.product` (and so `_mm`, the
attention core's batched products and the xLSTM cells' einsums) runs
under `marked(kind)`, `kind` `UNBATCHED` where its equation has no
index in both operands and the output, else `BATCHED`; the policy keeps
the one `mm` / `bmm` issued inside it ("dots": either kind;
"dots_no_batch": `UNBATCHED` only). The trailing cast to the product's
dtype is recomputed. A fused kernel's autograd Function
(`kernels/ops._FusedVJP`) runs its forward under `marked(FUSED)`, which
no product inside overrides: nothing of it is kept, on the card or in
its plain version on the CPU. As in the reference, whose fused kernels
are Pallas calls behind `custom_vjp` (no `dot_general` its policies can
keep), a fused layer under "dots" keeps what "nothing" keeps and runs
again whole.
"""

from __future__ import annotations

import contextvars
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

UNBATCHED, BATCHED, FUSED = "unbatched", "batched", "fused"

# the kinds of product each selective policy keeps
KEEPS = {"dots": (UNBATCHED, BATCHED), "dots_no_batch": (UNBATCHED,)}

_MARK: contextvars.ContextVar = contextvars.ContextVar("remat_mark",
                                                      default=None)
_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.bmm)


class marked:
    """Mark the ops issued inside the block as those of a product of
    `kind` (or of a fused kernel, `FUSED`). An enclosing mark stands: a
    product inside a fused kernel's plain version is the kernel's."""

    __slots__ = ("kind", "token")

    def __init__(self, kind: str):
        self.kind = kind
        self.token = None

    def __enter__(self):
        if _MARK.get() is None:
            self.token = _MARK.set(self.kind)

    def __exit__(self, *exc):
        if self.token is not None:
            _MARK.reset(self.token)
            self.token = None


@functools.lru_cache(maxsize=None)
def product_kind(eq: str, ndim_a: int, ndim_b: int) -> str:
    """`BATCHED` where the two-operand einsum `eq` on operands of
    `ndim_a` / `ndim_b` dims has an index in both operands and the output
    (an ellipsis in all three counts when it spans a dim), else
    `UNBATCHED`."""
    ins, out = eq.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    if "..." in ia and "..." in ib and "..." in out and \
            max(ndim_a - len(ia), ndim_b - len(ib)) + 3 > 0:
        return BATCHED
    ia, ib, out = (t.replace("...", "") for t in (ia, ib, out))
    return BATCHED if any(c in ia and c in ib for c in out) else UNBATCHED


def policy(name: str):
    """The `create_selective_checkpoint_contexts` policy function of
    cfg.remat `name` ("dots" or "dots_no_batch")."""
    keeps = KEEPS[name]

    def keep(ctx, func, *args, **kwargs):
        if func.overloadpacket in _PRODUCTS and _MARK.get() in keeps:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return keep


def contexts(name: str):
    """`checkpoint(context_fn=)` for cfg.remat `name`."""
    return functools.partial(create_selective_checkpoint_contexts,
                             policy(name))

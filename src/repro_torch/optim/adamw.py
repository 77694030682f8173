"""AdamW with dtype-configurable moments (the port of
`repro.optim.adamw`).

The update runs in f32 whatever the storage dtype, with the reference's
global-norm clip, bias corrections and decoupled weight decay; moments
are stored in `moment_dtype` (f32, or bf16 for the largest configs).
`torch.optim.AdamW` keeps its moments in the parameter's dtype (bf16
here), so it is not used.

Where the reference returns new trees, the port updates the parameters,
the moments and the step count in place, leaf by leaf, and `SLICE`
elements at a time: an f32 temporary of a whole leaf would cost 3.1 GB on
qwen3-14b's 777.9M-element embeddings. The step count, the bias
corrections, the clip and the learning rate stay 0-d tensors on the
device, so an update reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SLICE = 1 << 24          # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def adam_init(params, cfg: AdamConfig):
    """Zero moments of `moment_dtype` beside each parameter, and the step
    count (a 0-d int32 tensor on the parameters' device)."""
    dt = DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = pytree.tree_leaves(params)[0].device
    return {"m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _slices(*tensors):
    """Matching flat views of equal-sized contiguous tensors, SLICE
    elements at a time (a gradient may come non-contiguous from autograd:
    callers pass `g.contiguous()`)."""
    flats = [t.view(-1) for t in tensors]
    for lo in range(0, flats[0].numel(), SLICE):
        yield [f[lo:lo + SLICE] for f in flats]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (0-d tensor)."""
    sums = []
    for g in pytree.tree_leaves(tree):
        s = None
        for (part,) in _slices(g.contiguous()):
            t = torch.sum(torch.square(part.to(F32)))
            s = t if s is None else s + t
        sums.append(s)
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adam_update(params, grads, opt_state, cfg: AdamConfig, lr_scale=1.0):
    """One AdamW step, in place: `params`, ``opt_state["m"]`` / ``["v"]``
    and ``opt_state["step"]`` are updated and returned, with the metrics
    ``{"grad_norm": ...}``. `grads` is a tree like `params` (any float
    dtype)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)
    t = step.to(F32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale
    leaves = [pytree.tree_leaves(x) for x in
              (params, grads, opt_state["m"], opt_state["v"])]
    for p, g, m, v in zip(*leaves):
        for ps, gs, ms, vs in _slices(p, g.contiguous(), m, v):
            g32 = gs.to(F32) * clip
            m32, v32 = ms.to(F32), vs.to(F32)      # the moments themselves
            m32.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)    # when f32
            v32.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
            upd = torch.div(m32, bc1).div_(
                torch.div(v32, bc2).sqrt_().add_(cfg.eps))
            p32 = ps.to(F32)                       # ps itself when f32
            p32.sub_(upd.add_(p32, alpha=cfg.weight_decay).mul_(lr))
            for store, val in ((ps, p32), (ms, m32), (vs, v32)):
                if store.dtype != F32:
                    store.copy_(val)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm}

"""Load the reference package's parameters into the port's layout.

`from_jax_params(tree)` takes the numpy leaves of a reference parameter
tree (``repro.models.steps.init_params`` after ``np.asarray`` on every
leaf) and returns the port's parameters: the same tensors, with the
leading layer axis of each stacked super-block in ``tree["blocks"]``
unstacked into the list of per-layer dicts `repro_torch.models.steps`
uses, and likewise an encoder-decoder tree's ``tree["enc"]["blocks"]``.
bfloat16 leaves (numpy's ml_dtypes bfloat16) keep their bits. A
dict-valued key the port does not know raises: nothing is dropped.
`from_jax_train_state(state)` does the same for a reference train state
(``{"params", "opt": {"m", "v", "step"}}``): the moments have the
parameters' layout.

Nothing of the reference package is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy array (including ml_dtypes bfloat16) -> torch tensor on
    `device` (None: the GPU)."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(tree: dict, *, device=None) -> dict:
    """Reference parameter tree of numpy leaves -> port parameters on
    `device` (None: the GPU)."""
    device = resolve_device(device)
    unknown = [k for k, v in tree.items() if isinstance(v, dict)
               and k not in ("blocks", "rem", "enc")]
    if unknown:
        raise ValueError(f"from_jax_params: unknown subtrees {unknown}")
    blocks = tree["blocks"]
    subs = sorted(blocks, key=lambda k: int(k.removeprefix("sub")))
    n_super = _depth(blocks[subs[0]])
    layers = []
    for i in range(n_super):
        for sub in subs:
            layers.append(_layer(blocks[sub], i, device))
    if "rem" in tree:
        rem = tree["rem"]
        for key in sorted(rem, key=lambda k: int(k.removeprefix("rem"))):
            layers.append(_map(rem[key], lambda a: to_tensor(a, device)))
    out = {k: to_tensor(v, device) for k, v in tree.items()
           if not isinstance(v, dict)}
    out["blocks"] = layers
    if "enc" in tree:
        enc = tree["enc"]
        out["enc"] = {k: to_tensor(v, device) for k, v in enc.items()
                      if k != "blocks"}
        out["enc"]["blocks"] = [_layer(enc["blocks"], i, device)
                                for i in range(_depth(enc["blocks"]))]
    return out


def from_jax_train_state(state: dict, *, device=None) -> dict:
    """Reference train state of numpy leaves -> the port's
    ``{"params", "opt": {"m", "v", "step"}}`` on `device` (None: the GPU),
    the step count a 0-d int32 tensor."""
    device = resolve_device(device)
    opt = state["opt"]
    return {"params": from_jax_params(state["params"], device=device),
            "opt": {"m": from_jax_params(opt["m"], device=device),
                    "v": from_jax_params(opt["v"], device=device),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=device)}}


def _depth(stacked) -> int:
    """The leading (layers) axis of a stacked block tree."""
    return len(np.asarray(next(_leaves(stacked))))


def _layer(stacked, i: int, device):
    """Layer i of a stacked block tree, as tensors."""
    return _map(stacked, lambda a: to_tensor(np.asarray(a)[i], device))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree

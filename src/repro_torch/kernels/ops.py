"""Policy-dispatched kernel ops — the port's `repro.kernels.ops` for the
three fused kernels on the serving path (forward only; the custom-VJP
backward comes with the training slice).

Under the active `KernelPolicy`:

  * mode "reference" -> the plain oracle (`kernels/ref.py`);
  * mode "interpret" -> the kernel's plain PyTorch version (`fused.py`);
  * otherwise        -> the kernel wrapper: the Hopper kernel for CUDA
                        tensors, its plain version for CPU tensors.
"""

from __future__ import annotations

from repro_torch.cluster.policy import current_policy

from . import fused as _fused
from . import ref as _ref


def _route(name: str) -> str:
    pol = current_policy()
    mode = pol.mode_for(name)
    if mode == "reference":
        pol.bump("ref_calls")
        return "reference"
    if mode == "interpret":
        pol.bump("plain_calls")
        return "plain"
    pol.bump("kernel_calls")
    return "kernel"


def rmsnorm_matmul(x, scale, w):
    """matmul(rmsnorm(x, scale), w); the normed x never round-trips HBM."""
    route = _route("rmsnorm_matmul")
    if route == "reference":
        return _ref.rmsnorm_matmul(x, scale, w)
    if route == "plain":
        return _fused.rmsnorm_matmul_plain(x, scale, w)
    return _fused.rmsnorm_matmul(x, scale, w)


def matmul_residual_add(a, b, res):
    """a @ b + res; the matmul output never round-trips HBM."""
    route = _route("matmul_residual_add")
    if route == "reference":
        return _ref.matmul_residual_add(a, b, res)
    if route == "plain":
        return _fused.matmul_residual_add_plain(a, b, res)
    return _fused.matmul_residual_add(a, b, res)


def flash_attention_proj(q, k, v, wo, *, causal: bool = True):
    """Flash attention with the output projection fused across heads."""
    route = _route("flash_attention_proj")
    if route == "reference":
        return _ref.flash_attention_proj(q, k, v, wo, causal=causal)
    if route == "plain":
        return _fused.flash_attention_proj_plain(q, k, v, wo, causal)
    return _fused.flash_attention_proj(q, k, v, wo, causal)

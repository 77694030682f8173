"""Hand-written Hopper kernels of the port, their plain versions, and the
policy-dispatched ops. Nothing here builds or imports CUDA tooling at
import time: `build.py` compiles `csrc/` with nvcc on the first launch."""

from . import fused, launches, ops, ref

__all__ = ["fused", "launches", "ops", "ref"]

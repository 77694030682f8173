"""repro_torch — the PyTorch / CUDA port of `repro` for NVIDIA Hopper.

The JAX package `repro` stays the reference; this package imports neither
it nor jax. Kernels are hand-written CUDA C++ (`kernels/csrc/`), built
with nvcc on first use. Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""

from repro_torch.cluster import (Cluster, KernelPolicy, ServeProgram,
                                 ServeSessionProgram, TrainProgram,
                                 use_policy)
from repro_torch.configs import ARCHS, ArchConfig, get

__all__ = ["ARCHS", "ArchConfig", "Cluster", "KernelPolicy",
           "ServeProgram", "ServeSessionProgram", "TrainProgram", "get",
           "use_policy"]

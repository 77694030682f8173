from repro_torch.device import resolve_device

from .policy import (KernelPolicy, as_policy, current_policy, scoped,
                     use_policy)
from .session import Cluster, CompiledServeSession, ServeSessionProgram

__all__ = ["Cluster", "CompiledServeSession", "KernelPolicy",
           "ServeSessionProgram", "as_policy", "current_policy",
           "resolve_device", "scoped", "use_policy"]

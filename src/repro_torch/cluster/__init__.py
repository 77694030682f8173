from repro_torch.device import resolve_device

from .policy import (KernelPolicy, as_policy, current_policy, scoped,
                     use_policy)
from .session import (Cluster, CompiledServe, CompiledServeSession, Program,
                      ServeProgram, ServeSessionProgram)

__all__ = ["Cluster", "CompiledServe", "CompiledServeSession",
           "KernelPolicy", "Program", "ServeProgram", "ServeSessionProgram",
           "as_policy", "current_policy", "resolve_device", "scoped",
           "use_policy"]

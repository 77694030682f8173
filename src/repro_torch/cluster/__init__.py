from repro_torch.device import resolve_device

from .policy import (KernelPolicy, as_policy, current_policy, scoped,
                     use_policy)
from .session import (Cluster, CompiledServe, CompiledServeSession,
                      CompiledTrain, Program, ServeProgram,
                      ServeSessionProgram, TrainProgram)

__all__ = ["Cluster", "CompiledServe", "CompiledServeSession",
           "CompiledTrain", "KernelPolicy", "Program", "ServeProgram",
           "ServeSessionProgram", "TrainProgram", "as_policy",
           "current_policy", "resolve_device", "scoped", "use_policy"]

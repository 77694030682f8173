from repro_torch.device import resolve_device

from .policy import (KernelPolicy, as_policy, current_policy, scoped,
                     use_policy)
from .session import (Cluster, CompiledServe, CompiledServeSession,
                      CompiledShardedServeSession, CompiledTrain, Program,
                      ServeProgram, ServeSessionProgram,
                      ShardedServeSessionProgram, TrainProgram)

__all__ = ["Cluster", "CompiledServe", "CompiledServeSession",
           "CompiledShardedServeSession", "CompiledTrain", "KernelPolicy",
           "Program", "ServeProgram", "ServeSessionProgram",
           "ShardedServeSessionProgram", "TrainProgram", "as_policy",
           "current_policy", "resolve_device", "scoped", "use_policy"]

from repro_torch.device import resolve_device

from .policy import (KernelPolicy, as_policy, current_policy, scoped,
                     use_policy)
from .session import (Cluster, CompiledDryRun, CompiledServe,
                      CompiledServeSession, CompiledShardedServeSession,
                      CompiledTrain, DryRunProgram, Program, ServeProgram,
                      ServeSessionProgram, ShardedServeSessionProgram,
                      TrainProgram)

__all__ = ["Cluster", "CompiledDryRun", "CompiledServe",
           "CompiledServeSession", "CompiledShardedServeSession",
           "CompiledTrain", "DryRunProgram", "KernelPolicy",
           "Program", "ServeProgram", "ServeSessionProgram",
           "ShardedServeSessionProgram", "TrainProgram", "as_policy",
           "current_policy", "resolve_device", "scoped", "use_policy"]

from .compile_cache import CompileCache
from .engine import (DecodeEngine, StallClock, init_session_state,
                     make_decode_chunk, make_nan_scan, make_slot_corrupt,
                     make_slot_restore, make_slot_snapshot,
                     make_train_chunk, stack_batches)
from .faults import (Fault, FaultPlan, InjectedFault, SessionCrashed,
                     SessionWedged)
from .groups import (GroupPlan, GroupRuntime, GroupView, MeshScheduler,
                     ShardedServeSession)
from .journal import (Journal, ReplayedRequest, ReplaySummary, read_events,
                      replay)
from .kvpool import PagedKV, PagePool, PoolExhausted, PrefixCache, page_digests
from .scheduler import (QueueFull, Request, RequestFailed, RequestHandle,
                        SlotScheduler, deserialize_request, serialize_request)
from .serve_loop import ServeLoop, ServeSession
from .train_loop import StragglerDetector, TrainLoop, TrainLoopConfig

__all__ = ["CompileCache", "DecodeEngine", "Fault", "FaultPlan", "GroupPlan",
           "GroupRuntime", "GroupView", "InjectedFault", "Journal",
           "MeshScheduler", "PagePool", "PagedKV", "PoolExhausted",
           "PrefixCache", "QueueFull", "ReplaySummary", "ReplayedRequest",
           "Request", "RequestFailed", "RequestHandle", "ServeLoop",
           "ServeSession", "SessionCrashed", "SessionWedged",
           "ShardedServeSession", "SlotScheduler", "StallClock",
           "StragglerDetector", "TrainLoop", "TrainLoopConfig",
           "deserialize_request", "init_session_state", "make_decode_chunk",
           "make_nan_scan", "make_slot_corrupt", "make_slot_restore",
           "make_slot_snapshot", "make_train_chunk", "page_digests",
           "read_events", "replay", "serialize_request", "stack_batches"]

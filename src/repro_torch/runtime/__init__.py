from .compile_cache import CompileCache
from .engine import (DecodeEngine, StallClock, init_session_state,
                     make_decode_chunk, make_nan_scan, make_slot_corrupt,
                     make_slot_restore, make_slot_snapshot)
from .faults import (Fault, FaultPlan, InjectedFault, SessionCrashed,
                     SessionWedged)
from .journal import (Journal, ReplayedRequest, ReplaySummary, read_events,
                      replay)
from .kvpool import PagedKV, PagePool, PoolExhausted, PrefixCache, page_digests
from .scheduler import (QueueFull, Request, RequestFailed, RequestHandle,
                        SlotScheduler, deserialize_request, serialize_request)
from .serve_loop import ServeLoop, ServeSession

__all__ = ["CompileCache", "DecodeEngine", "Fault", "FaultPlan",
           "InjectedFault", "Journal", "PagePool", "PagedKV",
           "PoolExhausted", "PrefixCache", "QueueFull", "ReplaySummary",
           "ReplayedRequest", "Request", "RequestFailed", "RequestHandle",
           "ServeLoop", "ServeSession", "SessionCrashed", "SessionWedged",
           "SlotScheduler", "StallClock", "deserialize_request",
           "init_session_state", "make_decode_chunk", "make_nan_scan",
           "make_slot_corrupt", "make_slot_restore", "make_slot_snapshot",
           "page_digests", "read_events", "replay", "serialize_request"]

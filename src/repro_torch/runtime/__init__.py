from .engine import StallClock, init_session_state
from .kvpool import PagedKV, PagePool, PoolExhausted, PrefixCache
from .scheduler import QueueFull, Request, RequestHandle, SlotScheduler
from .serve_loop import ServeSession

__all__ = ["PagePool", "PagedKV", "PoolExhausted", "PrefixCache",
           "QueueFull", "Request", "RequestHandle", "ServeSession",
           "SlotScheduler", "StallClock", "init_session_state"]

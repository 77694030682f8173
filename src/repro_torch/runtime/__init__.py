from .compile_cache import CompileCache
from .engine import (DecodeEngine, StallClock, init_session_state,
                     make_decode_chunk)
from .kvpool import PagedKV, PagePool, PoolExhausted, PrefixCache
from .scheduler import QueueFull, Request, RequestHandle, SlotScheduler
from .serve_loop import ServeLoop, ServeSession

__all__ = ["CompileCache", "DecodeEngine", "PagePool", "PagedKV",
           "PoolExhausted", "PrefixCache", "QueueFull", "Request",
           "RequestHandle", "ServeLoop", "ServeSession", "SlotScheduler",
           "StallClock", "init_session_state", "make_decode_chunk"]

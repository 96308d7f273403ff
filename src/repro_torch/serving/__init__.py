"""Serving of the port: the lock-step ``ServingEngine`` and the
continuous-batching engine with its host-side ledgers and trace harness."""
from .engine import ServingEngine
from .slot_pool import RESERVED_TAIL, KVSlotPool, SlotPoolError, SourceKVPool
from .scheduler import OverloadConfig, Request, RequestState, Scheduler
from .telemetry import LogHistogram
from .continuous import ContinuousBatchingEngine
from .workload import load_trace, poisson_trace

__all__ = ["ServingEngine", "ContinuousBatchingEngine", "KVSlotPool",
           "SourceKVPool", "SlotPoolError", "RESERVED_TAIL", "OverloadConfig", "Request",
           "RequestState", "Scheduler", "LogHistogram", "load_trace",
           "poisson_trace"]

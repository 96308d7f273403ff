"""Serving of the port: the lock-step ``ServingEngine`` and the
continuous-batching engine with its host-side ledgers, telemetry, fault
injection, invariant auditor and trace harness."""
from .engine import ServingEngine
from .slot_pool import RESERVED_TAIL, KVSlotPool, SlotPoolError, SourceKVPool
from .scheduler import OverloadConfig, Request, RequestState, Scheduler
from .telemetry import Event, LogHistogram, Telemetry, load_events_jsonl
from .trace import chrome_trace, write_chrome_trace
from .faults import Fault, FaultInjected, FaultPlan
from .audit import AuditViolation, EngineAuditor
from .continuous import ContinuousBatchingEngine
from .workload import load_trace, poisson_trace

__all__ = ["ServingEngine", "ContinuousBatchingEngine", "KVSlotPool",
           "SourceKVPool", "SlotPoolError", "RESERVED_TAIL", "OverloadConfig", "Request",
           "RequestState", "Scheduler", "Event", "LogHistogram", "Telemetry",
           "load_events_jsonl", "chrome_trace", "write_chrome_trace", "Fault",
           "FaultInjected", "FaultPlan", "AuditViolation", "EngineAuditor",
           "load_trace", "poisson_trace"]

"""Serving of the port: the lock-step ``ServingEngine``. The continuous
batching engine waits for ROADMAP §1 item 5."""
from .engine import ServingEngine

__all__ = ["ServingEngine"]

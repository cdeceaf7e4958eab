"""Serving substrate: :class:`ServeEngine`, the LM slot-batching decode
engine.  Graph-query serving (``graphserve``, admission, stats) waits
for ROADMAP A11."""
from .engine import Request, ServeEngine

__all__ = ["ServeEngine", "Request"]

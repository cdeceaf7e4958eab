"""Serving substrate.

Two engines live here:

* :class:`GraphServer` (``graphserve``) — multi-tenant graph-query
  serving: resident plans, membudget admission control, cross-query
  batching along a leading query axis.
* :class:`ServeEngine` (``engine``) — the LM slot-batching decode
  engine (token streams through a fixed decode batch).
"""
from .admission import AdmissionController
from .engine import Request, ServeEngine
from .graphserve import GraphServer, Query
from .stats import ServingStats

__all__ = ["ServeEngine", "Request", "GraphServer", "Query",
           "AdmissionController", "ServingStats"]

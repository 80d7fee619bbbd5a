"""Serving: the continuous-batching engine with the optional pruned sparse
decode head."""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]

"""Operator API: ``plan → bind → LinearOperator`` (``@``, ``solve``) and the
pruned sparse layer (``pruned_linear``)."""

from .config import ExecutionConfig, Space
from .nn import pruned_linear
from .operator import LinearOperator, solve_operator
from .plan import PLAN_CACHE, Plan, PlanCache, plan

__all__ = ["ExecutionConfig", "Space", "LinearOperator", "solve_operator",
           "PLAN_CACHE", "Plan", "PlanCache", "plan", "pruned_linear"]

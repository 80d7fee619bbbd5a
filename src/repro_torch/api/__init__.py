"""Operator API: ``plan → bind → LinearOperator`` (``@``, ``solve``)."""

from .config import ExecutionConfig, Space
from .operator import LinearOperator, solve_operator
from .plan import PLAN_CACHE, Plan, PlanCache, plan

__all__ = ["ExecutionConfig", "Space", "LinearOperator", "solve_operator",
           "PLAN_CACHE", "Plan", "PlanCache", "plan"]

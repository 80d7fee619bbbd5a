"""Reliability policies, warning categories, and failure types.

The port's own copy of ``repro.reliability.policy`` (plain dataclasses; the
port imports nothing of the JAX package).  These are host-side
configuration objects a caller constructs once and threads through
``solve()`` / :class:`~repro_torch.serve.engine.ServeEngine`: the solver
escalation ladder, the serving admission/retry knobs, and the warning
taxonomy tests filter on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class ReliabilityWarning(UserWarning):
    """Base category for every degradation the reliability layer reports:
    guarded-apply downgrades, solver escalations, serving degraded mode.
    One warning per distinct event — the counters in ``core.counters``
    carry the per-occurrence tally."""


class SolveFailureWarning(ReliabilityWarning):
    """A solve returned without converging (status maxiter / breakdown /
    diverged / stagnated) and the caller did not opt into raising."""


class SolveFailure(RuntimeError):
    """Raised by ``solve(..., raise_on_failure=True)`` when the final
    status is not ``"converged"``.  Carries the last :class:`SolveResult`
    as ``.result`` so callers can still inspect the best iterate."""

    def __init__(self, msg: str, result=None):
        super().__init__(msg)
        self.result = result


@dataclasses.dataclass(frozen=True)
class SolvePolicy:
    """Escalation ladder for a failed Krylov solve:

    1. **restart** — re-run the planned solve warm-started from the last
       finite iterate (up to ``max_restarts``; skipped on ``breakdown``,
       where the restarted trajectory is identical);
    2. **method escalation** — ``cg`` → ``bicgstab`` (CG's breakdown on
       indefinite systems is exactly what BiCGStab tolerates);
    3. **reference apply** — re-run on the plain gather/``index_add_`` CSR
       matvec over the operator's bound values on its device,
       bypassing the planned kernel path entirely (recovers from
       kernel-level corruption the guarded-apply probe cannot see, e.g.
       chaos NaN injection).

    The stagnation/divergence sentinels are armed only when a policy is
    passed (``stagnation_window`` iterations without a relative residual
    improvement of ``stagnation_rtol`` → status ``"stagnated"``); the
    BiCGStab rho-breakdown detection is always on, with
    ``breakdown_tol=None`` meaning the accumulation dtype's eps (the
    Cauchy–Schwarz-relative threshold below which the computed rho is
    float noise).
    """

    max_restarts: int = 1
    escalate_method: bool = True
    escalate_reference: bool = True
    stagnation_window: int = 50
    # must be resolvable in the solve's accumulation dtype: fp32 cannot
    # represent relative improvements below ~6e-8, so an rtol much smaller
    # than 1e-4 makes every noise-level wiggle count as "progress"
    stagnation_rtol: float = 1e-4
    breakdown_tol: Optional[float] = None
    divergence_factor: float = 1e12


@dataclasses.dataclass(frozen=True)
class EnginePolicy:
    """Admission control + failure handling for :class:`ServeEngine`.

    ``max_queue=None`` keeps the legacy unbounded queue; a bound makes
    ``submit()`` reject-with-reason (``reject_reason="queue_full"``)
    instead of growing the deque without limit.  ``default_ttl_s`` stamps
    a deadline on requests that carry none; deadlines are enforced at
    admission and per step.  Transient step failures retry up to
    ``max_retries`` with exponential backoff starting at
    ``retry_backoff_s`` (0 = immediate retry, the test-friendly default);
    when retries are exhausted and a sparse head is serving, the engine
    enters degraded mode — the dense head path — rather than dropping
    admitted requests.
    """

    max_queue: Optional[int] = None
    max_retries: int = 2
    retry_backoff_s: float = 0.0
    default_ttl_s: Optional[float] = None

"""Reliability & graceful degradation for the port's EHYB stack.

DESIGN
======

Failure domains and their degradation ladders
---------------------------------------------

The port carries the JAX package's three recovery ladders.  Every rung is
observable (a ``ReliabilityWarning`` once per distinct event and a named
counter in ``core.counters``) and every ladder ends in a level that cannot
fail for the reason the rung above it did.

1. **Kernel dispatch** (``reliability.guard``).  A hand-written CUDA
   kernel can fail to build (``nvcc`` refuses the source), to load, or to
   launch (too much shared memory, a launch error, a fault during the run),
   and a device can be no Hopper card at all.  Recovery lives at host
   dispatch: ``Plan._raw_apply*`` hand out a stable-identity ``_Guard``
   that resolves, once per chaos epoch, which level of the format's
   fallback chain runs::

       fused kernel -> unfused (ELL-only kernel + plain ER) -> reference

   A kernel level of a CUDA plan must pass ``check_cuda_device`` and a
   probe (one run on a zero vector, synchronised, finite output); on a
   card only an injected fault moves it down the chain, and a kernel that
   fails to build or launch raises, as its wrapper does.  The
   reference level is plain PyTorch on the plan's own device: no level
   moves work to the CPU.  A downgrade shows in ``plan.degraded``, in the
   ``guard.downgrade`` counters and in one warning per (pattern, kind).

2. **Solver iteration** (``core.solver`` + ``api.operator``).  Krylov
   loops fail numerically: BiCGStab ρ/r̂·v/t·t breakdown, CG on an
   indefinite operator, divergence after kernel corruption, stagnation at
   an unreachable tolerance.  In-loop sentinels classify the failure into
   ``SolveResult.status`` (converged / maxiter / breakdown / diverged /
   stagnated); the host-side ladder in ``solve_operator``, driven by
   :class:`SolvePolicy`, then restarts from the last finite iterate,
   escalates cg → bicgstab, and finally re-runs on the reference CSR
   matvec that bypasses the planned kernels.  A result that still has not
   converged warns (:class:`SolveFailureWarning`) or raises
   (:class:`SolveFailure`).

3. **Serving** (``serve.engine``).  Overload and transient apply faults.
   :class:`EnginePolicy` adds a bounded queue (reject-with-reason),
   per-request deadlines enforced at admission and per step,
   retry-with-backoff around the prefill/decode steps (non-finite logits
   count as a failure), and a degraded mode that swaps the sparse pruned
   head for the dense path when the sparse apply keeps failing — admitted
   requests always finish or expire, never hang.

Fault injection (``reliability.chaos``) arms all three deterministically —
kernel-site failures by fnmatch pattern, NaN apply output, latency, serve
step budgets — so each recovery path has a test that proves its fault
fired (asserting on ``cfg.injected``) and that the system still computed
the right answer.
Chaos entry and exit bump an epoch, so no level resolved under injection
survives it.

Why host-side?  Build and launch failures are host phenomena, and a
branch inside every kernel would cost every apply for a case it almost
never takes.  The only in-loop machinery is the solver's status register,
which rides the existing loop state.
"""

from .chaos import ChaosConfig, ChaosFault, chaos, flood
from .guard import fallback_chain, guarded_apply, reference_apply
from .policy import (EnginePolicy, ReliabilityWarning, SolveFailure,
                     SolveFailureWarning, SolvePolicy)

__all__ = [
    "ChaosConfig",
    "ChaosFault",
    "chaos",
    "flood",
    "fallback_chain",
    "guarded_apply",
    "reference_apply",
    "EnginePolicy",
    "ReliabilityWarning",
    "SolveFailure",
    "SolveFailureWarning",
    "SolvePolicy",
]

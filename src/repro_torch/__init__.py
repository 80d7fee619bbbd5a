"""PyTorch/CUDA port of the EHYB SpMV framework (``repro``) for NVIDIA Hopper.

Mirrors the JAX package's layout — ``core`` (host format build, device
containers, plain applies, CG), ``kernels`` (hand-written CUDA kernels with
their plain versions), ``autotune`` (the formats' registry, the bytes-moved
cost model, the format and partition-strategy tuner), ``tuning`` (tunable
kernel parameters), ``api`` (``plan → bind → apply/solve``),
``reliability`` (guarded apply, solve policy, fault injection) — and is
held against it module by module.  It imports ``torch`` and never ``jax``
or ``repro``.

    from repro_torch.api import ExecutionConfig, SolvePolicy, plan

    p  = plan(A)                       # format and partition autotuned
    op = p.bind(A)                     # device tables (default: cuda)
    y  = op @ x
    r  = op.solve(b, precond="spai")
    r  = op.solve(b, method="bicgstab", precond="spai",
                  policy=SolvePolicy())     # escalation ladder armed
"""

from .reliability import (ReliabilityWarning, SolveFailure,
                          SolveFailureWarning, SolvePolicy, chaos)

__all__ = ["ReliabilityWarning", "SolveFailure", "SolveFailureWarning",
           "SolvePolicy", "chaos"]

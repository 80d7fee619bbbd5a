"""PyTorch/CUDA port of the EHYB SpMV framework (``repro``) for NVIDIA Hopper.

Mirrors the JAX package's layout — ``core`` (host format build, device
containers, plain applies, CG), ``kernels`` (hand-written CUDA and Triton
kernels with their plain versions), ``autotune`` (format registry), ``api``
(``plan → bind → apply/solve``), ``reliability`` (guarded apply, solve
policy, fault injection) — and is held against it module by module.  It
imports ``torch`` and never ``jax`` or ``repro``.

    from repro_torch.api import ExecutionConfig, SolvePolicy, plan

    p  = plan(A, execution=ExecutionConfig(format="ehyb_packed",
                                           partition_method="bfs"))
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

"""Operator API: the value-bound :class:`LinearOperator` and its solver.

The port of ``repro.api.operator``.  ``op @ x`` works in
:attr:`Space.ORIGINAL`, on one vector ``(n,)`` or a batch ``(n, K)`` (K ≥ 2
goes to the SpMM kernels); hot loops hoist the permutation with
``x̃ = op.to_space(x)`` / ``op.apply(x̃, space=Space.PERMUTED)`` /
``op.from_space(ỹ)``.  Every apply goes through the plan's guard
(``reliability.guard``).  ``op.solve`` runs CG or BiCGStab in the permuted
space exactly as the JAX package's ``solve_operator`` does: b, x0 and the
preconditioner diagonal are permuted once per solve, the matvec is the
format's guarded permuted-space apply, and the result is carried back once.
A :class:`~repro_torch.reliability.SolvePolicy` adds the escalation ladder
(warm restarts, cg → bicgstab, the reference CSR solve), and a
non-converged result always warns or raises.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional

import numpy as np
import torch

from ..autotune.registry import get_format
from ..core import solver as S
from ..core.counters import bump
from ..core.matrices import SparseCSR
from ..core.solver import SolveResult, precond_inv_diag
from ..core.spmv import _as_2d, _from_permuted, _to_permuted, coo_spmv
from ..reliability.policy import (ReliabilityWarning, SolveFailure,
                                  SolveFailureWarning, SolvePolicy)
from .config import Space
from .plan import Plan


def _as_space(space) -> Space:
    if isinstance(space, Space):
        return space
    if space in ("original", "permuted"):
        return Space(space)
    raise ValueError(f"unknown space {space!r}; use repro_torch.api.Space")


@dataclasses.dataclass(eq=False)
class LinearOperator:
    """A sparse matrix bound to its planned device format.  Construct with
    :meth:`repro_torch.api.Plan.bind`."""

    plan: Plan
    obj: Any                 # the format's device container
    dtype: torch.dtype       # value dtype of the device tables
    csr: SparseCSR           # host matrix (pattern + bound values)
    _precond: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.plan.n

    @property
    def nnz(self) -> int:
        return self.plan.nnz

    @property
    def shape(self) -> tuple:
        return (self.plan.n, self.plan.n)

    @property
    def format(self) -> str:
        return self.plan.format

    @property
    def device(self) -> torch.device:
        return self.plan.device

    # ---- apply -------------------------------------------------------------

    def _promote(self, x) -> torch.Tensor:
        """``x`` as a tensor on the operator's device in its value dtype —
        the operator computes in the dtype it was bound with."""
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def __matmul__(self, x) -> torch.Tensor:
        return self.plan._raw_apply()(self.obj, self._promote(x))

    def __call__(self, x) -> torch.Tensor:
        return self @ x

    def apply(self, x, space: Space = Space.ORIGINAL) -> torch.Tensor:
        """``A @ x`` in the given space: ``Space.ORIGINAL`` takes/returns
        length-``n`` vectors (or ``(n, R)`` batches), ``Space.PERMUTED``
        ``(n_pad[, R])`` vectors of the execution space."""
        if _as_space(space) is Space.ORIGINAL:
            return self @ x
        return self.matvec_permuted(self._promote(x))

    @property
    def matvec_permuted(self):
        """``x_new -> y_new`` in the permuted space (the solver's matvec),
        through the plan's guard."""
        guard = self.plan._raw_apply_permuted()
        return lambda x_new: guard(self.obj, x_new)

    # ---- spaces ------------------------------------------------------------

    @property
    def supports_permuted(self) -> bool:
        return get_format(self.format).permuted is not None

    @property
    def n_pad(self) -> int:
        return self.obj.n_pad

    def to_space(self, x, space: Space = Space.PERMUTED) -> torch.Tensor:
        """Carry original-space vector(s) into ``space`` (once per loop)."""
        x = self._promote(x)
        if _as_space(space) is Space.ORIGINAL:
            return x
        xn, squeeze = _to_permuted(self.obj, x)
        return xn[:, 0] if squeeze else xn

    def from_space(self, y, space: Space = Space.PERMUTED) -> torch.Tensor:
        """Carry vector(s) in ``space`` back to the original space."""
        y = torch.as_tensor(y, device=self.device)
        if _as_space(space) is Space.ORIGINAL:
            return y
        y2, squeeze = _as_2d(y)
        return _from_permuted(self.obj, y2, squeeze)

    # ---- solving -----------------------------------------------------------

    def precond_inv_permuted(self, kind: str) -> Optional[np.ndarray]:
        """The inverse-diagonal preconditioner carried into the permuted
        space (host float64, memoized): slot i gets the entry of original
        vertex ``perm[i]``; padding slots get 1.0 (their residual
        coordinates are identically zero)."""
        if kind not in self._precond:
            inv = precond_inv_diag(self.csr, kind)
            if inv is not None:
                perm = self.obj.perm.cpu().numpy()
                inv_pad = np.ones(self.n_pad)
                live = perm < self.n
                inv_pad[live] = inv[perm[live]]
                inv = inv_pad
            self._precond[kind] = inv
        return self._precond[kind]

    def solve(self, b, *, method: str = "cg", precond: str = "jacobi",
              x0=None, tol: float = 1e-6, max_iters: int = 500,
              fused_update="auto", policy: Optional[SolvePolicy] = None,
              raise_on_failure: bool = False,
              warn: bool = True) -> SolveResult:
        """Solve ``A x = b`` with this operator driving the Krylov loop in
        the permuted space; ``x0`` warm starts it.  See
        :func:`solve_operator`."""
        return solve_operator(self, b, method=method, precond=precond,
                              x0=x0, tol=tol, max_iters=max_iters,
                              fused_update=fused_update, policy=policy,
                              raise_on_failure=raise_on_failure, warn=warn)


def _inv_tensor(inv: Optional[np.ndarray], acc, device):
    return None if inv is None else torch.as_tensor(inv, dtype=acc,
                                                    device=device)


def _reference_solve(op: LinearOperator, b: torch.Tensor, *, method: str,
                     precond: str, x0, tol: float, max_iters: int,
                     kw_guard: dict) -> SolveResult:
    """Escalation rung 3: re-run the Krylov loop on a plain CSR matvec (a
    gather and ``index_add_``) on the operator's device, in the original
    space — no planned kernels, no permutation — so it recovers even from
    kernel-level output corruption the guard's probe cannot see.  Its
    values are the bound ones as the guard's reference level reads them
    (``Plan.values_of``)."""
    a = op.csr
    rows, cols = op.plan.coo_tensors()
    vals = op.plan.values_of(op.obj).to(b.dtype)

    def mv(x):
        return coo_spmv(rows, cols, vals, x[:, None], a.n)[:, 0]

    acc = torch.promote_types(b.dtype, torch.float32)
    inv = _inv_tensor(precond_inv_diag(a, precond), acc, op.device)
    pre = None if inv is None else (lambda r: inv * r)
    return S.SOLVERS[method](mv, b, pre, tol=tol, max_iters=max_iters,
                             x0=x0, **kw_guard)


def _better(r_old: SolveResult, r_new: SolveResult) -> SolveResult:
    """The more useful of two solve attempts: converged wins; otherwise the
    smaller finite residual (NaN never beats a finite iterate)."""
    if bool(r_new.converged):
        return r_new
    if bool(r_old.converged):
        return r_old
    res_new, res_old = float(r_new.residual), float(r_old.residual)
    if math.isfinite(res_new) != math.isfinite(res_old):
        return r_new if math.isfinite(res_new) else r_old
    return r_new if res_new <= res_old else r_old


def solve_operator(op: LinearOperator, b, *, method: str = "cg",
                   precond: str = "jacobi", x0=None, tol: float = 1e-6,
                   max_iters: int = 500, fused_update="auto",
                   policy: Optional[SolvePolicy] = None,
                   raise_on_failure: bool = False,
                   warn: bool = True) -> SolveResult:
    """Solve ``A x = b`` on a bound operator, in its permuted space.

    ``method`` is ``"cg"`` or ``"bicgstab"``.  ``fused_update="auto"``
    takes the fused CG-step kernel for CG on a CUDA device and the plain
    update otherwise; BiCGStab has no fused step (``fused_update=True``
    with it raises).  The JAX package enables its kernel only on a TPU,
    because that kernel's cross-step dot accumulation races on a parallel
    grid; the port's kernel reduces in two deterministic passes, so that
    reason does not hold here.

    Failure handling, as in the JAX package:

    * a final non-converged status warns
      (:class:`~repro_torch.reliability.SolveFailureWarning`) or, with
      ``raise_on_failure=True``, raises
      :class:`~repro_torch.reliability.SolveFailure` carrying the result;
      ``warn=False`` silences the warning, never the raise;
    * a :class:`~repro_torch.reliability.SolvePolicy` arms the solver's
      stagnation/divergence sentinels and the escalation ladder — warm
      restarts, cg → bicgstab, then the reference CSR solve on the
      operator's device — each rung counted (``solver.restart``,
      ``solver.escalate_method``, ``solver.escalate_reference``) and the
      ladder reported in one :class:`ReliabilityWarning`.
    """
    if method not in S.SOLVERS:
        raise ValueError(f"unknown method {method!r}; "
                         f"have {sorted(S.SOLVERS)}")
    if fused_update is True and method != "cg":
        raise ValueError(
            f"fused_update is a CG-step kernel; method {method!r} has no "
            f"fused vector-update path")
    if fused_update == "auto":
        fused_update = op.device.type == "cuda" and method == "cg"
    b = op._promote(b)
    if b.dim() != 1:
        raise ValueError(f"solve() takes one right-hand side of shape "
                         f"({op.n},), got {tuple(b.shape)}")
    acc = torch.promote_types(b.dtype, torch.float32)
    inv_t = _inv_tensor(op.precond_inv_permuted(precond), acc, op.device)
    pre = None if inv_t is None else (lambda r: inv_t * r)
    b_new = op.to_space(b)
    mv = op.matvec_permuted
    kw_guard = {}
    if policy is not None:
        kw_guard = {"stag_window": policy.stagnation_window,
                    "stag_rtol": policy.stagnation_rtol,
                    "div_factor": policy.divergence_factor}

    def _run(method_, x0_orig) -> SolveResult:
        kw = dict(kw_guard)
        if method_ == "cg":
            kw.update(fused_update=bool(fused_update), precond_inv=inv_t)
        elif policy is not None and policy.breakdown_tol is not None:
            kw["breakdown_tol"] = policy.breakdown_tol
        x0_new = None if x0_orig is None else op.to_space(x0_orig)
        r = S.SOLVERS[method_](mv, b_new, pre, tol=tol, max_iters=max_iters,
                               x0=x0_new, **kw)
        return r._replace(x=op.from_space(r.x))

    r = _run(method, x0)
    stages: list = []
    if policy is not None and not bool(r.converged):

        def _warm(res):       # never warm start from a corrupted iterate
            return res.x if bool(torch.isfinite(res.x).all()) else x0

        cur = method
        restarts = 0
        while (not bool(r.converged) and r.status != "breakdown"
               and restarts < policy.max_restarts):
            restarts += 1
            bump("solver.restart")
            stages.append(f"restart[{cur}]")
            r = _better(r, _run(cur, _warm(r)))
        if not bool(r.converged) and policy.escalate_method and cur == "cg":
            cur = "bicgstab"
            bump("solver.escalate_method")
            stages.append("escalate:bicgstab")
            r = _better(r, _run(cur, _warm(r)))
        if not bool(r.converged) and policy.escalate_reference:
            bump("solver.escalate_reference")
            stages.append("escalate:reference")
            kw_ref = dict(kw_guard)
            if policy.breakdown_tol is not None and cur == "bicgstab":
                kw_ref["breakdown_tol"] = policy.breakdown_tol
            x0_ref = _warm(r)
            r = _better(r, _reference_solve(
                op, b, method=cur, precond=precond,
                x0=None if x0_ref is None else op._promote(x0_ref), tol=tol,
                max_iters=max_iters, kw_guard=kw_ref))
        if stages:
            warnings.warn(f"solve escalated through {', '.join(stages)} "
                          f"(final status {r.status!r})", ReliabilityWarning,
                          stacklevel=3)
    return _finalize_solve(r, tuple(stages), raise_on_failure, warn)


def _finalize_solve(r: SolveResult, stages: tuple, raise_on_failure: bool,
                    warn: bool) -> SolveResult:
    """Terminal accounting: a non-converged result is never silent unless
    the caller passed ``warn=False``."""
    if bool(r.converged):
        if stages:
            bump("solver.recovered")
        return r
    bump("solver.failed")
    msg = (f"solve did not converge: status={r.status!r}, "
           f"residual={float(r.residual):.3e}, iters={int(r.iters)}")
    if stages:
        msg += f"; escalation tried: {', '.join(stages)}"
    if raise_on_failure:
        raise SolveFailure(msg, result=r)
    if warn:
        warnings.warn(msg, SolveFailureWarning, stacklevel=4)
    return r

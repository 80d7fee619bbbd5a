"""Operator API: the value-bound :class:`LinearOperator` and its solver.

The port of ``repro.api.operator`` for this slice.  ``op @ x`` works in
:attr:`Space.ORIGINAL`; hot loops hoist the permutation with
``x̃ = op.to_space(x)`` / ``op.apply(x̃, space=Space.PERMUTED)`` /
``op.from_space(ỹ)``.  ``op.solve`` runs CG in the permuted space exactly as
the JAX package's ``solve_operator`` does: b, x0 and the preconditioner
diagonal are permuted once per solve, the matvec is the format's
permuted-space apply, and the result is carried back once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..autotune.registry import get_format
from ..core.matrices import SparseCSR
from ..core.solver import SolveResult, cg, precond_inv_diag
from ..core.spmv import _as_2d, _from_permuted, _to_permuted
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
        return get_format(self.format).apply(self.obj, self._promote(x))

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
        """``x_new -> y_new`` in the permuted space (the solver's matvec)."""
        permuted = get_format(self.format).permuted
        return lambda x_new: permuted(self.obj, x_new)

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
              fused_update="auto") -> SolveResult:
        """Solve ``A x = b`` with this operator driving the Krylov loop in
        the permuted space; ``x0`` warm starts it."""
        return solve_operator(self, b, method=method, precond=precond,
                              x0=x0, tol=tol, max_iters=max_iters,
                              fused_update=fused_update)


def solve_operator(op: LinearOperator, b, *, method: str = "cg",
                   precond: str = "jacobi", x0=None, tol: float = 1e-6,
                   max_iters: int = 500,
                   fused_update="auto") -> SolveResult:
    """Solve ``A x = b`` on a bound operator, in its permuted space.

    ``fused_update="auto"`` takes the fused CG-step kernel on a CUDA device
    and the plain update on the CPU.  The JAX package enables its kernel
    only on a TPU, because that kernel's cross-step dot accumulation races
    on a parallel grid; the port's kernel reduces in two deterministic
    passes, so that reason does not hold here.
    """
    if method != "cg":
        raise NotImplementedError(
            f"method {method!r}: only 'cg' is ported so far (bicgstab is "
            f"ROADMAP Queue 1 item 4)")
    if fused_update == "auto":
        fused_update = op.device.type == "cuda"
    b = op._promote(b)
    if b.dim() != 1:
        raise ValueError(f"solve() takes one right-hand side of shape "
                         f"({op.n},), got {tuple(b.shape)}")
    acc = torch.promote_types(b.dtype, torch.float32)
    inv = op.precond_inv_permuted(precond)
    inv_t = None if inv is None else torch.as_tensor(inv, dtype=acc,
                                                     device=op.device)
    pre = None if inv_t is None else (lambda r: inv_t * r)
    x0_new = None if x0 is None else op.to_space(x0)
    r = cg(op.matvec_permuted, op.to_space(b), pre, tol=tol,
           max_iters=max_iters, fused_update=bool(fused_update),
           precond_inv=inv_t, x0=x0_new)
    return SolveResult(x=op.from_space(r.x), iters=r.iters,
                       residual=r.residual, converged=r.converged,
                       status_code=r.status_code)

"""Preconditioned Krylov solvers — the paper's target workload (§1, §6).

The port of ``repro.core.solver``'s CG and BiCGStab with their status
register and their breakdown, divergence and stagnation guards, and of the
diagonal preconditioners (``jacobi`` and diagonal ``spai``).  The solver takes an
opaque ``matvec``, so any SpMV path drops in — the paper's experiment: same
Krylov loop, swap the SpMV.  ``api.operator.solve_operator`` runs it in the
EHYB permuted space (b and the preconditioner diagonal permuted once per
solve, never per iteration).

The JAX loop is one device ``while_loop``.  Here the loop is Python over
device tensors: every scalar (alpha, beta, the dots, the status register)
stays on the device, and the host reads the stop condition only once every
``_CHECK_EVERY`` (8) iterations.  Iterations past the stop are masked with
``torch.where`` on a device-side "running" flag, so ``x``, ``iters`` and
``status`` are what a check after every iteration would give.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .matrices import SparseCSR

STATUS_CONVERGED, STATUS_MAXITER, STATUS_BREAKDOWN, STATUS_DIVERGED, \
    STATUS_STAGNATED = range(5)
STATUS_NAMES = ("converged", "maxiter", "breakdown", "diverged", "stagnated")
_RUNNING = -1   # in-loop sentinel: no terminal status assigned yet
_CHECK_EVERY = 8   # iterations between two host reads of the stop condition


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor
    status_code: torch.Tensor    # int32 0-d, one of STATUS_*

    @property
    def status(self) -> str:
        """Human-readable status name (reads the device scalar)."""
        return STATUS_NAMES[int(self.status_code)]


# ---------------------------------------------------------------------------
# preconditioners (diagonal family)
# ---------------------------------------------------------------------------

def _matrix_diag(m: SparseCSR) -> tuple[np.ndarray, np.ndarray]:
    rows = np.repeat(np.arange(m.n), m.row_lengths())
    diag = np.zeros(m.n)
    on_diag = rows == m.indices
    diag[rows[on_diag]] = m.data[on_diag]
    return rows, diag


def precond_inv_diag(m: SparseCSR, kind: str) -> Optional[np.ndarray]:
    """The inverse-diagonal array M⁻¹ of preconditioner ``kind`` (None for
    identity), float64 on the host."""
    if kind == "none":
        return None
    rows, diag = _matrix_diag(m)
    if kind == "jacobi":
        d = np.where(diag == 0, 1.0, diag)
        return (1.0 / d).astype(np.float64)
    if kind == "spai":
        # Diagonal SPAI: argmin_M ||I − MA||_F over diagonal M; row-wise
        # closed form m_i = a_ii / Σ_j a_ij².
        row_sq = np.zeros(m.n)
        np.add.at(row_sq, rows, m.data ** 2)
        mdiag = diag / np.where(row_sq == 0, 1.0, row_sq)
        return np.where(mdiag == 0, 1.0, mdiag).astype(np.float64)
    raise ValueError(f"unknown preconditioner {kind!r}; "
                     f"have {list(PRECONDITIONERS)}")


def _diag_closure(inv: Optional[np.ndarray]) -> Callable:
    """``r -> M⁻¹ r`` for the inverse diagonal ``inv`` (identity for None),
    the diagonal carried at the wider of r's dtype and fp32 on r's
    device."""
    if inv is None:
        return lambda r: r

    def apply(r):
        acc = torch.promote_types(r.dtype, torch.float32)
        return torch.as_tensor(inv, dtype=acc, device=r.device) * r

    return apply


def identity_precond(_: SparseCSR) -> Callable:
    return _diag_closure(None)


def jacobi_precond(m: SparseCSR) -> Callable:
    return _diag_closure(precond_inv_diag(m, "jacobi"))


def spai_diag_precond(m: SparseCSR) -> Callable:
    """Diagonal SPAI closure (see :func:`precond_inv_diag`)."""
    return _diag_closure(precond_inv_diag(m, "spai"))


# the reference's table: preconditioner name -> closure factory
PRECONDITIONERS = {
    "none": identity_precond,
    "jacobi": jacobi_precond,
    "spai": spai_diag_precond,
}


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------

def _classify_exit(status, res, tol):
    """Post-loop status: a loop that exited without an in-loop sentinel
    either converged, ran out of iterations, or started non-finite."""
    return torch.where(
        status >= 0, status,
        torch.where(res <= tol, STATUS_CONVERGED,
                    torch.where(torch.isfinite(res), STATUS_MAXITER,
                                STATUS_DIVERGED))).to(torch.int32)


def _dot_fn(acc: torch.dtype, group=None) -> Callable:
    """The solvers' inner product in ``acc``; with a process group, summed
    over its ranks (``all_reduce``)."""
    def _dot(u, v):
        d = torch.dot(u.to(acc), v.to(acc))
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(d, group=group)
        return d
    return _dot


def cg(matvec: Callable, b: torch.Tensor,
       precond: Optional[Callable] = None, tol: float = 1e-6,
       max_iters: int = 500, *, fused_update: bool = False,
       precond_inv: Optional[torch.Tensor] = None,
       x0: Optional[torch.Tensor] = None, stag_window: int = 0,
       stag_rtol: float = 1e-8, div_factor: float = 1e12,
       group=None) -> SolveResult:
    """Preconditioned conjugate gradients on (n,) vectors.

    ``precond`` maps r to z (None = identity).  ``fused_update=True`` routes
    the vector updates through :func:`repro_torch.kernels.solver_step.
    fused_cg_update` (the CG-step kernel on the card, its plain version on
    the CPU) and takes the preconditioner as the diagonal ``precond_inv``
    (None = ones).  ``x0`` warm starts (None = zeros); convergence stays
    relative to ‖b‖.

    Guards, as in the JAX package: ``p·Ap ≤ 0`` is a breakdown — the step
    rolls back and the loop exits ``"breakdown"``; a non-finite or exploding
    ‖r‖² (``> div_factor·max(‖b‖², ‖r₀‖²)``) rolls back and exits
    ``"diverged"``; ``stag_window > 0`` exits ``"stagnated"`` after that
    many iterations without a relative best-residual improvement of
    ``stag_rtol``.  The host reads the stop condition once every
    ``_CHECK_EVERY`` iterations; the iterations in between are masked.

    ``group`` (a ``torch.distributed`` process group; the counterpart of the
    JAX package's ``axis_name``) runs the same recurrence distributed: b and
    every vector the loop carries are the rank's shard of a sharded system,
    and every dot is ``all_reduce``-d (SUM) over the group, so the scalars,
    the trajectory and the stop are the same on every rank.  Distributed
    solves use the plain update path: ``fused_update=True`` with a group
    raises, as in the JAX package.
    """
    if fused_update and group is not None:
        raise ValueError("fused_update is a single-device CG-step kernel; "
                         "distributed solves use the plain update path")
    dt = b.dtype
    acc = torch.promote_types(dt, torch.float32)   # dots/norms in ≥fp32
    dev = b.device
    _dot = _dot_fn(acc, group)
    if fused_update:
        from ..kernels.solver_step import fused_cg_update

        inv_vec = (torch.ones(b.shape, dtype=acc, device=dev)
                   if precond_inv is None
                   else precond_inv.to(device=dev, dtype=torch.promote_types(
                       precond_inv.dtype, torch.float32)))

    def _z(r):
        if fused_update:
            return (inv_vec * r).to(dt)
        return (r if precond is None else precond(r)).to(dt)

    x = torch.zeros_like(b) if x0 is None else x0.to(dtype=dt, device=dev)
    r = (b - matvec(x)).to(dt)
    p = _z(r)
    rz = _dot(r, p)
    rr = _dot(r, r)
    tiny = torch.finfo(acc).tiny
    bnorm2 = torch.clamp(_dot(b, b), min=tiny)
    thresh2 = (tol ** 2) * bnorm2
    div_thresh = div_factor * torch.maximum(bnorm2, rr)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    status = torch.full((), _RUNNING, dtype=torch.int32, device=dev)
    best = rr.clone()
    since = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=acc, device=dev)

    def running():
        return (status < 0) & (rr > thresh2) & (k < max_iters)

    for it in range(max_iters):
        run = running()
        if it % _CHECK_EVERY == 0 and not bool(run):
            break
        ap = matvec(p)
        pap = _dot(p, ap)
        breakdown = pap <= 0          # not SPD along p: recurrence is dead
        # on breakdown the whole step rolls back below, so alpha's value
        # there never reaches the result
        alpha = rz / torch.where(breakdown, one, torch.clamp(pap, min=1e-30))
        if fused_update:
            x_n, r_n, z, rz_new, rr_new = fused_cg_update(
                x, r, p, ap, inv_vec, alpha.to(torch.float32))
            rz_new, rr_new = rz_new.to(acc), rr_new.to(acc)
        else:
            x_n = (x + alpha * p).to(dt)
            r_n = (r - alpha * ap).to(dt)
            z = _z(r_n)
            rz_new = _dot(r_n, z)
            rr_new = _dot(r_n, r_n)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_n = (z + beta * p).to(dt)
        bad = breakdown | ~torch.isfinite(rr_new) | (rr_new > div_thresh)
        improved = rr_new < best * (1 - stag_rtol)
        since_n = torch.where(improved | bad, 0, since + 1).to(torch.int32)
        stalled = (stag_window > 0) & (since_n >= stag_window) \
            & (rr_new > thresh2)
        status_n = torch.where(
            breakdown, STATUS_BREAKDOWN,
            torch.where(bad, STATUS_DIVERGED,
                        torch.where(stalled, STATUS_STAGNATED,
                                    _RUNNING))).to(torch.int32)
        # roll back a bad step (keep a merely-stagnated one: it was valid),
        # and leave the whole state as it was once the loop has stopped
        keep = run & ~bad
        x = torch.where(keep, x_n, x)
        r = torch.where(keep, r_n, r)
        p = torch.where(keep, p_n, p)
        rz = torch.where(keep, rz_new, rz)
        rr = torch.where(keep, rr_new, rr)
        k = k + keep.to(torch.int32)
        status = torch.where(run, status_n, status)
        best = torch.where(run, torch.minimum(best, rr), best)
        since = torch.where(run, since_n, since)
    return _result(x, k, rr, bnorm2, status, tol)


def _result(x, k, rr, bnorm2, status, tol) -> SolveResult:
    res = torch.sqrt(rr / bnorm2)
    status = _classify_exit(status, res, tol)
    return SolveResult(x=x, iters=k, residual=res,
                       converged=status == STATUS_CONVERGED,
                       status_code=status)


def bicgstab(matvec: Callable, b: torch.Tensor,
             precond: Optional[Callable] = None, tol: float = 1e-6,
             max_iters: int = 500, *, x0: Optional[torch.Tensor] = None,
             stag_window: int = 0, stag_rtol: float = 1e-8,
             div_factor: float = 1e12,
             breakdown_tol: Optional[float] = None,
             group=None) -> SolveResult:
    """Preconditioned BiCGStab for non-symmetric systems, on (n,) vectors.

    ``precond`` maps r to z (None = identity); ``x0`` warm starts as in
    :func:`cg`.  Its vector updates are plain tensor ops on every device:
    the JAX package has no fused BiCGStab step either.

    Breakdown is detected, not masked: ``|ρ| ≤ breakdown_tol·√(‖r̂‖²‖r‖²)``
    (Cauchy–Schwarz-relative; ``breakdown_tol=None`` is the accumulation
    dtype's eps) or ``|r̂·v| ≤ 1e-30`` keeps the pre-step iterate and exits
    ``"breakdown"``; ``t·t ≤ 1e-30`` with ``s`` not yet converged keeps the
    valid half-step (x += α·p̂, r = s) and exits ``"breakdown"``; when ``s``
    has converged the half-step finishes the solve.  Divergence rolls back
    and stagnation stops as in :func:`cg`.  The loop is :func:`cg`'s: device
    scalars, a host read of the stop condition every ``_CHECK_EVERY``
    iterations and masked iterations in between, so it stops where the JAX
    ``while_loop`` does.  ``group`` distributes the dots as in :func:`cg`.
    """
    dt = b.dtype
    acc = torch.promote_types(dt, torch.float32)   # dots/norms in ≥fp32
    dev = b.device
    _dot = _dot_fn(acc, group)

    def _z(r):
        return (r if precond is None else precond(r)).to(dt)

    x = torch.zeros_like(b) if x0 is None else x0.to(dtype=dt, device=dev)
    r = (b - matvec(x)).to(dt)
    rhat = r
    rr = _dot(r, r)
    rhat2 = rr                        # ‖r̂‖² (r̂ is frozen at r₀)
    bt = torch.finfo(acc).eps if breakdown_tol is None else breakdown_tol
    bnorm2 = torch.clamp(_dot(b, b), min=torch.finfo(acc).tiny)
    thresh2 = (tol ** 2) * bnorm2
    div_thresh = div_factor * torch.maximum(bnorm2, rr)
    one = torch.ones((), dtype=acc, device=dev)
    rho, alpha, omega = one, one, one
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    status = torch.full((), _RUNNING, dtype=torch.int32, device=dev)
    best = rr.clone()
    since = torch.zeros((), dtype=torch.int32, device=dev)

    def nz(d):           # keeps a discarded branch's arithmetic finite
        return torch.where(d == 0, 1e-30, d)

    for it in range(max_iters):
        run = (status < 0) & (rr > thresh2) & (k < max_iters)
        if it % _CHECK_EVERY == 0 and not bool(run):
            break
        rho_new = _dot(rhat, r)
        rho_break = rho_new.abs() <= bt * torch.sqrt(rhat2) * torch.sqrt(rr)
        beta = (rho_new / nz(rho)) * (alpha / nz(omega))
        p_n = (r + beta * (p - omega * v)).to(dt)
        ph = _z(p_n)
        v_n = matvec(ph)
        rv = _dot(rhat, v_n)
        rv_break = rv.abs() <= 1e-30
        alpha_n = rho_new / torch.where(rv_break, one, rv)
        s = (r - alpha_n * v_n).to(dt)
        ss = _dot(s, s)
        s_conv = ss <= thresh2
        sh = _z(s)
        t = matvec(sh)
        tt = _dot(t, t)
        tt_break = (tt <= 1e-30) & ~s_conv
        omega_n = _dot(t, s) / torch.clamp(tt, min=1e-30)
        x_half = (x + alpha_n * ph).to(dt)
        x_full = (x_half + omega_n * sh).to(dt)
        r_full = (s - omega_n * t).to(dt)
        rr_full = _dot(r_full, r_full)
        # three-way select: dead recurrence -> keep the pre-step iterate;
        # early s-convergence or t-breakdown -> keep the valid half-step;
        # otherwise the full BiCGStab step
        pick_old = rho_break | rv_break
        pick_half = ~pick_old & (s_conv | tt_break)

        def sel(old, half, full):
            return torch.where(pick_old, old,
                               torch.where(pick_half, half, full))

        x_n, r_n, rr_n = sel(x, x_half, x_full), sel(r, s, r_full), \
            sel(rr, ss, rr_full)
        blow = (~torch.isfinite(rr_n) | (rr_n > div_thresh)) & ~pick_old
        x_n = torch.where(blow, x, x_n)
        r_n = torch.where(blow, r, r_n)
        rr_n = torch.where(blow, rr, rr_n)
        improved = rr_n < best * (1 - stag_rtol)
        bad = pick_old | blow
        since_n = torch.where(improved | bad, 0, since + 1).to(torch.int32)
        stalled = (stag_window > 0) & (since_n >= stag_window) \
            & (rr_n > thresh2)
        status_n = torch.where(
            pick_old | tt_break, STATUS_BREAKDOWN,
            torch.where(blow, STATUS_DIVERGED,
                        torch.where(stalled, STATUS_STAGNATED,
                                    _RUNNING))).to(torch.int32)
        # once the loop has stopped the whole state stays as it was
        x = torch.where(run, x_n, x)
        r = torch.where(run, r_n, r)
        rho = torch.where(run, rho_new, rho)
        alpha = torch.where(run, alpha_n, alpha)
        omega = torch.where(run, omega_n, omega)
        v = torch.where(run, v_n, v)
        p = torch.where(run, p_n, p)
        rr = torch.where(run, rr_n, rr)
        k = k + (run & ~bad).to(torch.int32)
        status = torch.where(run, status_n, status)
        best = torch.where(run, torch.minimum(best, rr_n), best)
        since = torch.where(run, since_n, since)
    return _result(x, k, rr, bnorm2, status, tol)


SOLVERS = {"cg": cg, "bicgstab": bicgstab}


# ---------------------------------------------------------------------------
# legacy entry points: DeprecationWarning shims over repro_torch.api
# ---------------------------------------------------------------------------

def precond_for(a: SparseCSR, kind: str, op=None,
                space: str = "original") -> Callable:
    """Deprecated: the preconditioner closure ``r -> M⁻¹ r`` for matrix
    ``a`` in the given execution space; ``space="permuted"`` needs the
    bound operator ``op`` (a ``repro_torch.api.LinearOperator`` or the
    legacy ``SpMVOperator``), whose permutation carries the diagonal into
    its space as ``op.solve`` does (padding slots get 1.0).  Use
    ``op.solve(b, precond=kind)``, or ``op.precond_inv_permuted(kind)``
    for the permuted diagonal."""
    import warnings

    warnings.warn("core.solver.precond_for is deprecated; use "
                  "repro_torch.api: op.solve(b, precond=...) or "
                  "op.precond_inv_permuted(kind)", DeprecationWarning,
                  stacklevel=2)
    inv = precond_inv_diag(a, kind)
    if space == "permuted":
        if op is None or not op.supports_permuted:
            raise ValueError("space='permuted' needs an operator with a "
                             "permuted execution space")
        if inv is not None:
            perm = op.obj.perm.cpu().numpy()
            inv_pad = np.ones(op.n_pad)
            live = perm < a.n
            inv_pad[live] = inv[perm[live]]
            inv = inv_pad
    elif space != "original":
        raise ValueError(f"unknown space {space!r}")
    return _diag_closure(inv)


def solve(a, b, *, method: str = "cg", precond: str = "jacobi",
          format: str = "auto", tol: float = 1e-6, max_iters: int = 500,
          space: str = "auto", fused_update="auto", x0=None,
          device=None) -> SolveResult:
    """Deprecated: use ``repro_torch.api`` —
    ``plan(A, execution=ExecutionConfig(workload="solver")).bind(A)
    .solve(b)``.

    Solve ``A x = b``: a :class:`SparseCSR` ``a`` is planned with the
    solver-context cost model and bound at b's dtype (on b's device for a
    tensor b, else on ``device``, default ``cuda``); a bound
    ``repro_torch.api.LinearOperator`` solves as it is."""
    import warnings

    warnings.warn(
        "core.solver.solve is deprecated; use repro_torch.api: "
        "plan(A, execution=ExecutionConfig(workload='solver'))"
        ".bind(A).solve(b, ...)", DeprecationWarning, stacklevel=2)
    from ..api import ExecutionConfig
    from ..api.operator import LinearOperator, solve_operator
    from ..api.plan import plan as _plan

    if space not in ("auto", "original", "permuted"):
        raise ValueError(f"unknown space {space!r}")
    if isinstance(a, SparseCSR):
        if isinstance(b, torch.Tensor):
            device = b.device
        b = torch.as_tensor(b)
        dtype = b.dtype if b.is_floating_point() else torch.float32
        a = _plan(a, execution=ExecutionConfig(format=format,
                                               workload="solver"),
                  device=device).bind(a, dtype=dtype)
    elif not isinstance(a, LinearOperator):
        raise TypeError(f"solve takes a SparseCSR or a "
                        f"repro_torch.api.LinearOperator, "
                        f"got {type(a).__name__}")
    return solve_operator(a, b, method=method, precond=precond, x0=x0,
                          tol=tol, max_iters=max_iters, space=space,
                          fused_update=fused_update)

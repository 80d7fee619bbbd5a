"""Operator API: the value-bound :class:`LinearOperator` and its solver.

The port of ``repro.api.operator``.  ``op @ x`` works in
:attr:`Space.ORIGINAL`, on one vector ``(n,)`` or a batch ``(n, K)`` (K ≥ 2
goes to the SpMM kernels); hot loops hoist the permutation with
``x̃ = op.to_space(x)`` / ``op.apply(x̃, space=Space.PERMUTED)`` /
``op.from_space(ỹ)``.  Every apply goes through the plan's guard
(``reliability.guard``).  ``op.update_values`` binds new values on the
same pattern (a refill, ``Plan.bind``); ``op.T`` is the operator of Aᵀ on
the transpose plan.

**Gradients.**  When grad mode is on and x or the bound values require
grad (values bound from a tensor, ``plan.bind(tensor)``), or either is
wrapped by a ``torch.func`` transform, an apply runs through
:class:`_DiffApply`, the counterpart of the JAX package's ``custom_vjp``
apply: the cotangent of the values is gathered per nonzero,
``v̄ₖ = Σ_r ḡ[rowₖ, r]·x[colₖ, r]``, once for each value (so no copy of a
value in another table counts it twice), and the cotangent of x is Aᵀ ḡ,
applied by the transpose plan's operator bound at the accumulation dtype
(at least fp32, never the stored one) to the bound tensor reordered.  The
backward is itself differentiable (double backward, HVPs), in either
space and on a mesh, and ``torch.func.grad``, ``jacrev`` and ``vmap``
accept the apply: ``vmap`` over right-hand sides is one batched apply,
over value sets a bind and an apply a set.  Otherwise the apply is the
guard's alone and builds no graph; a solve never does.

**Sharded plans** (``plan(A, mesh=)``): every rank calls each method with
the same arguments.  ``op @ x`` takes the replicated global x and returns
the replicated global y; the permuted space is the rank's
``(local_size[, R])`` shard (``to_space`` cuts it, ``from_space`` gathers
the shards back); ``op.solve`` runs the Krylov loop on the shards with the
halo exchange as the matvec's only communication and every dot
``all_reduce``-d over the mesh axis's group (``_solve_sharded``).

``op.solve`` runs CG or BiCGStab in the permuted space (``space="auto"``
for the EHYB family, as the JAX package's ``solve_operator`` does: b, x0
and the preconditioner diagonal are permuted once per solve, the matvec is
the format's guarded permuted-space apply, and the result is carried back
once) or on the original-space apply (``space="original"``, and
``"auto"`` for a format without a permuted space).  A
:class:`~repro_torch.reliability.SolvePolicy` adds the escalation ladder
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
from ..core.spmv import _as_2d, _from_permuted, _to_permuted, coo_product
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


def _wrapped(t) -> bool:
    """Whether ``t`` is a tensor that a ``torch.func`` transform wrapped."""
    return isinstance(t, torch.Tensor) and \
        torch._C._functorch.is_functorch_wrapped_tensor(t)


def _unwrapped(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every ``torch.func`` wrapper peeled off (under ``vmap``,
    the whole batch)."""
    while _wrapped(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def _to_original(plan: Plan, obj, t2: torch.Tensor) -> torch.Tensor:
    """Permuted-space ``(rows, R)`` -> original ``(n, R)``: a local
    container's padded space, or the rank's shard gathered from every
    rank (one all-gather)."""
    if plan.is_sharded:
        from ..dist.operator import gather_original

        return gather_original(obj, t2)
    return _from_permuted(obj, t2, False)


def _to_permuted_of(plan: Plan, obj, t2: torch.Tensor) -> torch.Tensor:
    """Original ``(n, R)`` -> the permuted space (a sharded container's:
    the rank's shard); padding slots get zero."""
    if plan.is_sharded:
        from ..dist.operator import shard_of

        return shard_of(obj, t2)
    return _to_permuted(obj, t2)[0]


class _DiffApply(torch.autograd.Function):
    """``y = A x`` through ``plan``'s guarded apply of container ``obj``
    (tables of ``dtype``; None: bound here from ``values``, for an operator
    bound under a ``torch.func`` transform), differentiable in the bound
    per-nnz ``values`` (None for host-bound values) and in ``x`` (original
    space, or permuted with ``permuted=True``).  y comes back in the wider
    of x's and the tables' dtypes, so the cotangent keeps x's precision.

    The backward is built from differentiable ops, as the JAX package's
    ``custom_vjp`` backward is, so it can be differentiated again: v̄ from
    index ops, and x̄ = Aᵀ ḡ through :func:`apply_operator` on the
    transpose plan bound to ``values`` reordered (the graph reaches
    ``values``).  Under a plain ``backward()`` grad mode is off there and
    x̄ is one transpose bind and one apply.  A sharded permuted-space
    product is taken in the original space: ḡ and x are gathered there
    (one all-gather each) and x̄ is cut back to the rank's shard.

    ``vmap`` (the staticmethod) makes a batch of right-hand sides one
    ``(n, B)`` apply, and binds and applies a batch of value sets one set
    at a time."""

    @staticmethod
    def forward(values, x, plan, obj, dtype, permuted):
        if obj is None:
            obj = plan._container(values, dtype)
        guard = plan._raw_apply_permuted() if permuted else plan._raw_apply()
        y = guard(obj, x.to(dtype))
        return y.to(torch.promote_types(x.dtype, dtype))

    @staticmethod
    def setup_context(ctx, inputs, output):
        values, x, plan, obj, dtype, permuted = inputs
        ctx.save_for_backward(values, x)
        ctx.plan, ctx.dtype, ctx.permuted = plan, dtype, permuted
        ctx.obj = obj if obj is not None else plan._layout(dtype)

    @staticmethod
    def backward(ctx, g):
        values, x = ctx.saved_tensors
        plan, obj = ctx.plan, ctx.obj
        acc = torch.promote_types(torch.promote_types(g.dtype, x.dtype),
                                  torch.float32)
        x2, squeeze = _as_2d(x)
        g2 = _as_2d(g)[0]
        if ctx.permuted:         # the product is the original one, permuted
            x2 = _to_original(plan, obj, x2)
            g2 = _to_original(plan, obj, g2)
        grad_values = grad_x = None
        if ctx.needs_input_grad[0]:
            rows, cols = plan.coo_tensors()
            grad_values = (g2.index_select(0, rows).to(acc)
                           * x2.index_select(0, cols).to(acc)).sum(1).to(
                               values.dtype)
        if ctx.needs_input_grad[1]:
            # the tables' values: the bound tensor rounded as the bind
            # rounded it, else read from the tables
            vals = plan.values_of(obj) if values is None else \
                values.to(ctx.dtype)
            t_vals = vals.to(acc).index_select(0,
                                               plan.transpose_order_tensor())
            gx = plan.transpose.bind(t_vals, dtype=acc, validate=False) @ \
                g2.to(acc)
            if ctx.permuted:
                gx = _to_permuted_of(plan, obj, gx)
            grad_x = (gx[:, 0] if squeeze else gx).to(x.dtype)
        return grad_values, grad_x, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, values, x, plan, obj, dtype, permuted):
        v_dim, x_dim = in_dims[:2]
        if v_dim is None:
            # a batch of right-hand sides: one apply of (rows, [K·]B)
            xb = x.movedim(x_dim, -1)
            y = _DiffApply.apply(values, xb.reshape(xb.shape[0], -1), plan,
                                 obj, dtype, permuted)
            return y.reshape(y.shape[:1] + xb.shape[1:]).movedim(-1, 0), 0
        # a batch of value sets: each bound and applied in turn
        ys = [_DiffApply.apply(
            values.select(v_dim, i),
            x if x_dim is None else x.select(x_dim, i), plan, None, dtype,
            permuted) for i in range(info.batch_size)]
        return torch.stack(ys), 0


def apply_operator(plan: Plan, obj, dtype: torch.dtype, x,
                   values: Optional[torch.Tensor] = None,
                   permuted: bool = False) -> torch.Tensor:
    """``A x`` of container ``obj`` bound on ``plan`` (tables of ``dtype``)
    through the plan's guard, in the original space or, with
    ``permuted=True``, the permuted one.  The apply computes on x cast to
    ``dtype``; y comes back in the wider of x's dtype and ``dtype`` for a
    floating-point tensor x, and in ``dtype`` for any other x — with grad
    mode on or off.  It runs through :class:`_DiffApply` when grad mode is
    on and ``x`` or the bound per-nnz ``values`` require grad, and when
    either is wrapped by a ``torch.func`` transform (wrapped values were
    bound under it, so ``obj`` holds the structure only and the apply binds
    them); otherwise it is the guard's apply alone."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        x = x.to(plan.device)
    else:
        x = torch.as_tensor(x, device=plan.device).to(dtype)
    if _wrapped(values):
        return _DiffApply.apply(values, x, plan, None, dtype, permuted)
    if _wrapped(x) or (torch.is_grad_enabled() and (x.requires_grad or (
            values is not None and values.requires_grad))):
        return _DiffApply.apply(values, x, plan, obj, dtype, permuted)
    guard = plan._raw_apply_permuted() if permuted else plan._raw_apply()
    return guard(obj, x.to(dtype)).to(torch.promote_types(x.dtype, dtype))


@dataclasses.dataclass(eq=False)
class LinearOperator:
    """A sparse matrix bound to its planned device format.  Construct with
    :meth:`repro_torch.api.Plan.bind`."""

    plan: Plan
    obj: Any                 # the format's device container
    dtype: torch.dtype       # value dtype of the device tables
    # host matrix (pattern + bound values); made from the tables on first
    # use when the values were bound from a tensor
    _csr: Optional[SparseCSR] = dataclasses.field(default=None, repr=False)
    # the (nnz,) tensor the values were bound from (autograd reaches it)
    _values: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    _precond: dict = dataclasses.field(default_factory=dict, repr=False)
    _precond_t: dict = dataclasses.field(default_factory=dict, repr=False)

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

    @property
    def tuning(self):
        """The plan's format-autotuning result (None for a pinned
        format)."""
        return self.plan.tuning

    @property
    def values(self) -> torch.Tensor:
        """The bound per-nnz values in CSR order, on the device: the tensor
        they were bound from, else as the tables hold them
        (``Plan.values_of``)."""
        if self._values is not None:
            return self._values
        return self.plan.values_of(self.obj)

    @property
    def csr(self) -> SparseCSR:
        """Host CSR of the bound matrix (pattern + values)."""
        if self._csr is None:
            p = self.plan.pattern
            self._csr = SparseCSR(self.n, p.indptr, p.indices,
                                  self.values.detach().double().cpu().numpy())
        return self._csr

    # ---- apply -------------------------------------------------------------

    def _promote(self, x) -> torch.Tensor:
        """``x`` as a tensor on the operator's device in its value dtype —
        the operator computes in the dtype it was bound with."""
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def __matmul__(self, x) -> torch.Tensor:
        return apply_operator(self.plan, self.obj, self.dtype, x,
                              self._values)

    def __call__(self, x) -> torch.Tensor:
        return self @ x

    def apply(self, x, space: Space = Space.ORIGINAL) -> torch.Tensor:
        """``A @ x`` in the given space: ``Space.ORIGINAL`` takes/returns
        length-``n`` vectors (or ``(n, R)`` batches), ``Space.PERMUTED``
        ``(n_pad[, R])`` vectors of the execution space."""
        if _as_space(space) is Space.ORIGINAL:
            return self @ x
        return self.matvec_permuted(x)

    @property
    def matvec_permuted(self):
        """``x_new -> y_new`` in the permuted space (the solver's matvec),
        through the plan's guard."""
        return lambda x_new: apply_operator(self.plan, self.obj, self.dtype,
                                            x_new, self._values,
                                            permuted=True)

    # ---- spaces ------------------------------------------------------------

    @property
    def supports_permuted(self) -> bool:
        return get_format(self.format).permuted is not None

    @property
    def n_pad(self) -> int:
        """Rows of the permuted execution space (a sharded operator's: all
        ranks' shards together, ``n_dev · local_size``)."""
        if not self.supports_permuted:
            raise ValueError(f"format {self.format!r} has no permuted "
                             f"execution space")
        return self.obj.n_pad

    def to_space(self, x, space: Space = Space.PERMUTED) -> torch.Tensor:
        """Carry original-space vector(s) into ``space`` (once per loop);
        a sharded operator's permuted space is the rank's shard."""
        x = self._promote(x)
        if _as_space(space) is Space.ORIGINAL:
            return x
        if self.plan.is_sharded:
            from ..dist.operator import shard_of

            return shard_of(self.obj, x)
        xn, squeeze = _to_permuted(self.obj, x)
        return xn[:, 0] if squeeze else xn

    def from_space(self, y, space: Space = Space.PERMUTED) -> torch.Tensor:
        """Carry vector(s) in ``space`` back to the original space (a
        sharded operator gathers the ranks' shards)."""
        y = torch.as_tensor(y, device=self.device)
        if _as_space(space) is Space.ORIGINAL:
            return y
        if self.plan.is_sharded:
            from ..dist.operator import gather_original

            return gather_original(self.obj, y)
        y2, squeeze = _as_2d(y)
        return _from_permuted(self.obj, y2, squeeze)

    @property
    def halo_plan(self):
        """The sharded plan's halo-exchange schedule
        (:class:`repro_torch.dist.HaloPlan`; None for a local plan)."""
        if not self.plan.is_sharded:
            return None
        return self.plan._engine(self).plan

    # ---- lifecycle ---------------------------------------------------------

    def update_values(self, values) -> "LinearOperator":
        """Same pattern, new values: ``plan.bind`` at this operator's dtype
        — a refill of the value tables, no partitioning, no build, no
        packing, the structural tensors shared.

        Takes exactly one argument: the refill keeps the plan's format and
        this operator's dtype, and an unknown keyword raises rather than
        being dropped."""
        return self.plan.bind(values, dtype=self.dtype)

    def transpose(self) -> "LinearOperator":
        """``Aᵀ`` bound on the transpose plan (a cache hit for a
        structurally symmetric pattern), from the values on the device."""
        t = self.plan.transpose_order_tensor()
        return self.plan.transpose.bind(self.values.index_select(0, t),
                                        dtype=self.dtype)

    @property
    def T(self) -> "LinearOperator":
        return self.transpose()

    # ---- solving -----------------------------------------------------------

    def precond_inv_permuted(self, kind: str) -> Optional[np.ndarray]:
        """The inverse-diagonal preconditioner carried into the permuted
        space (host float64, memoized): slot i gets the entry of original
        vertex ``perm[i]``; padding slots get 1.0 (their residual
        coordinates are identically zero).  A sharded operator's covers
        every rank's slots."""
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

    def precond_tensor(self, kind: str, dtype: torch.dtype,
                       permuted: bool) -> Optional[torch.Tensor]:
        """The preconditioner diagonal as a tensor of ``dtype`` on the
        operator's device, uploaded once per bound operator: in the
        permuted space (a sharded operator's: its rank's slots) or the
        original one.  None for the identity."""
        key = (kind, dtype, permuted)
        if key not in self._precond_t:
            inv = self.precond_inv_permuted(kind) if permuted else \
                precond_inv_diag(self.csr, kind)
            if inv is not None and self.plan.is_sharded and permuted:
                lo = self.obj.rank * self.obj.local_size
                inv = inv[lo: lo + self.obj.local_size]
            self._precond_t[key] = _inv_tensor(inv, dtype, self.device)
        return self._precond_t[key]

    def solve(self, b, *, method: str = "cg", precond: str = "jacobi",
              x0=None, tol: float = 1e-6, max_iters: int = 500,
              space="auto", fused_update="auto",
              policy: Optional[SolvePolicy] = None,
              raise_on_failure: bool = False,
              warn: bool = True) -> SolveResult:
        """Solve ``A x = b`` with this operator driving the Krylov loop in
        ``space`` (``"auto"``: the permuted space); ``x0`` warm starts it.
        See :func:`solve_operator`."""
        return solve_operator(self, b, method=method, precond=precond,
                              x0=x0, tol=tol, max_iters=max_iters,
                              space=space, fused_update=fused_update,
                              policy=policy,
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
        return coo_product(rows, cols, vals, x[:, None], a.n)[:, 0]

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
                   max_iters: int = 500, space="auto", fused_update="auto",
                   policy: Optional[SolvePolicy] = None,
                   raise_on_failure: bool = False,
                   warn: bool = True) -> SolveResult:
    """Solve ``A x = b`` on a bound operator (no autograd graph: b and x0
    are detached and the matvec reads the tables alone).

    ``space`` is where the Krylov loop runs: ``"permuted"`` (and
    ``"auto"`` for a format that has a permuted space, the EHYB family)
    permutes b, x0 and the preconditioner diagonal once and runs the
    permuted-space apply; ``"original"`` (and ``"auto"`` for ``csr``,
    ``ell``, ``hyb`` and ``dense``) runs the original-space apply on b as
    given.
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
    if op.plan.is_sharded:
        return _solve_sharded(op, b, method=method, precond=precond, x0=x0,
                              tol=tol, max_iters=max_iters, space=space,
                              fused_update=fused_update, policy=policy,
                              raise_on_failure=raise_on_failure, warn=warn)
    if fused_update == "auto":
        fused_update = op.device.type == "cuda" and method == "cg"
    if space in ("auto", None):
        permuted = op.supports_permuted
    else:
        permuted = _as_space(space) is Space.PERMUTED
    if permuted and not op.supports_permuted:
        raise ValueError(f"format {op.format!r} has no permuted execution "
                         f"space")
    run_space = Space.PERMUTED if permuted else Space.ORIGINAL
    b = op._promote(b).detach()
    if x0 is not None:
        x0 = torch.as_tensor(x0).detach()
    if b.dim() != 1:
        raise ValueError(f"solve() takes one right-hand side of shape "
                         f"({op.n},), got {tuple(b.shape)}")
    acc = torch.promote_types(b.dtype, torch.float32)
    inv_t = op.precond_tensor(precond, acc, permuted)
    pre = None if inv_t is None else (lambda r: inv_t * r)
    b_new = op.to_space(b, run_space)
    # the guard on the tables alone: no input of the loop requires grad,
    # so it builds no autograd graph whatever the bound values require
    guard = op.plan._raw_apply_permuted() if permuted else \
        op.plan._raw_apply()

    def mv(x):
        return guard(op.obj, x)
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
        x0_new = None if x0_orig is None else op.to_space(x0_orig,
                                                          run_space)
        r = S.SOLVERS[method_](mv, b_new, pre, tol=tol, max_iters=max_iters,
                               x0=x0_new, **kw)
        return r._replace(x=op.from_space(r.x, run_space))

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


def _solve_sharded(op: LinearOperator, b, *, method: str, precond: str,
                   x0, tol: float, max_iters: int, space, fused_update,
                   policy: Optional[SolvePolicy], raise_on_failure: bool,
                   warn: bool) -> SolveResult:
    """The sharded solve (reference ``_solve_sharded_engine``): b and x0
    (global, the same on every rank) cut to the rank's permuted shard once,
    the preconditioner diagonal's shard kept on the device, the Krylov loop
    on the shards through the engine's ``solver_runner`` (halo exchange in
    the matvec, dots ``all_reduce``-d), and x gathered back.  A
    :class:`SolvePolicy` arms the solver's sentinels; as in the reference a
    sharded solve reports its status and does not escalate.  Distributed
    solves use the plain vector updates (``fused_update=True`` raises)."""
    if fused_update is True:
        raise ValueError("fused_update is a single-device CG-step kernel; "
                         "distributed solves use the plain update path")
    if space not in ("auto", None) and _as_space(space) is not \
            Space.PERMUTED:
        raise ValueError("a sharded solve runs in the permuted space")
    b = op._promote(b).detach()
    if b.dim() != 1:
        raise ValueError(f"solve() takes one right-hand side of shape "
                         f"({op.n},), got {tuple(b.shape)}")
    from ..dist.operator import gather_original, shard_of

    acc = torch.promote_types(b.dtype, torch.float32)
    inv_loc = op.precond_tensor(precond, acc, True)
    x0_loc = None if x0 is None else shard_of(
        op.obj, op._promote(torch.as_tensor(x0).detach()))
    kw = {}
    if policy is not None:
        kw = {"stag_window": policy.stagnation_window,
              "stag_rtol": policy.stagnation_rtol,
              "div_factor": policy.divergence_factor}
        if method == "bicgstab" and policy.breakdown_tol is not None:
            kw["breakdown_tol"] = policy.breakdown_tol
    run = op.plan._engine(op).solver_runner(method)
    r = run(op.obj, shard_of(op.obj, b), x0_loc, inv_loc, tol, max_iters,
            **kw)
    r = r._replace(x=gather_original(op.obj, r.x))
    return _finalize_solve(r, (), raise_on_failure, warn)


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

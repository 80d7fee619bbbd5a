"""The control: the plain reference put in the program's place, one
precision below the configuration's float32.  Values and vectors are
stored in bfloat16, products summed in float32 and rounded back, as a
bfloat16 port of the operator would do.  Its answers have to fail the
checks that the program's pass (``ehyb_bench/limits/``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ehyb_bench.reference.rows import PaddedRows

LOW = torch.bfloat16


class ControlResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor


class ControlOperator:
    """``op @ x`` and ``op.solve(b, ...)`` as the harness's loops call
    them, computed in bfloat16."""

    def __init__(self, matrix, device):
        self.rows = PaddedRows(matrix, device, dtype=LOW)
        self.n = self.rows.n
        self.nnz = int(matrix.nnz)
        diag = self.rows.vals.float() * (
            self.rows.cols == torch.arange(self.n, device=device)[:, None])
        d = diag.sum(1)
        self.inv_diag = torch.where(d == 0, 1.0, 1.0 / d).to(LOW)

    def _mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.rows.matmul(x.to(LOW), acc=torch.float32).to(LOW)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self._mv(x).float()

    def solve(self, b, *, method="cg", precond="jacobi", tol=1e-6,
              max_iters=500, **_):
        """Preconditioned CG with every vector in bfloat16 and the dots in
        float32; stops once ‖r‖ ≤ tol‖b‖ by its own recurrence."""
        if method != "cg":
            raise ValueError(f"the control solves with cg, not {method!r}")
        inv = self.inv_diag if precond == "jacobi" else \
            torch.ones_like(self.inv_diag)

        def dot(u, v):
            return torch.dot(u.float(), v.float())

        b = b.to(LOW)
        x = torch.zeros_like(b)
        r = b.clone()
        z = (inv * r).to(LOW)
        p = z.clone()
        rz = dot(r, z)
        bb = dot(b, b)
        k = 0
        while k < max_iters and float(dot(r, r)) > tol * tol * float(bb):
            ap = self._mv(p)
            alpha = rz / dot(p, ap)
            x = (x.float() + alpha * p.float()).to(LOW)
            r = (r.float() - alpha * ap.float()).to(LOW)
            z = (inv * r).to(LOW)
            rz_new = dot(r, z)
            p = (z.float() + (rz_new / rz) * p.float()).to(LOW)
            rz = rz_new
            k += 1
        converged = float(dot(r, r)) <= tol * tol * float(bb)
        return ControlResult(x=x.float(), iters=torch.tensor(k),
                             converged=torch.tensor(converged))

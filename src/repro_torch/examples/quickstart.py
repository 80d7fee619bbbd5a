"""Quickstart: the operator API lifecycle — plan → bind → apply.

The port of ``examples/quickstart.py``.  One pattern-only ``plan(A)`` picks
the best device format for the matrix via the autotuner's bytes-moved cost
model and records everything value-independent (partitioning, reordering).
``bind`` fills in the values, and the resulting ``LinearOperator`` is the
operator: ``op @ x`` runs the SpMV, ``op.update_values`` refreshes values
on a fixed pattern without re-planning, and autograd flows through both
``x`` and the bound values.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import poisson3d
from repro_torch.core.matrices import SparseCSR


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    # 1. a 3-D Poisson matrix (7-point stencil, 16³ grid) — the paper's CFD
    #    category
    m = poisson3d(16)
    print(f"matrix: n={m.n} nnz={m.nnz}")

    # 2. the lifecycle: plan once per pattern, bind per value set
    p = api.plan(m, device=dev)
    print(f"plan: {p}")
    for fmt, b in sorted(p.tuning.modeled_bytes.items(),
                         key=lambda kv: kv[1]):
        print(f"  {fmt:14s} modeled {b/m.nnz:7.2f} bytes/nnz")

    op = p.bind(m)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(m.n),
                        dtype=torch.float32, device=op.device)
    y_ref = m.spmv(x.double().cpu().numpy())
    scale = np.abs(y_ref).max()
    y = (op @ x).cpu().numpy()
    rel = {"op @ x": np.abs(y - y_ref).max() / scale}
    print(f"op @ x      max rel err = {rel['op @ x']:.2e}")

    # 3. value refresh on a fixed pattern: one scatter, zero re-planning
    m2 = SparseCSR(m.n, m.indptr, m.indices, m.data * 2.0)
    op2 = op.update_values(m2)
    y2 = (op2 @ x).cpu().numpy()
    rel["update_values"] = np.abs(y2 - 2 * y_ref).max() / scale
    print(f"update_values: max rel err vs 2A@x = {rel['update_values']:.2e} "
          f"(same plan: {op2.plan is p})")

    # 4. the paper's format, forced: EHYB preprocessing stats + the
    #    explicit execution-space API
    pe = api.plan(m, execution=api.ExecutionConfig(format="ehyb"),
                  device=dev)
    ope = pe.bind(m)
    host = pe.host_build(m)
    print(f"EHYB: partitions={host.n_parts} vec_size={host.vec_size} "
          f"in-partition={host.in_part_fraction:.1%} "
          f"ell_width={host.ell_width} er_rows={host.er_rows}")
    print(f"preprocess: {host.preprocess_seconds['total']*1e3:.1f} ms "
          f"(partition {host.preprocess_seconds['partition']*1e3:.1f} ms)")
    x_tilde = ope.to_space(x, api.Space.PERMUTED)     # hoist once
    y_tilde = ope.apply(x_tilde, space=api.Space.PERMUTED)
    y_e = ope.from_space(y_tilde, api.Space.PERMUTED).cpu().numpy()
    rel["permuted"] = np.abs(y_e - y_ref).max() / scale
    print(f"permuted-space apply max rel err = {rel['permuted']:.2e}")

    # 5. operators are differentiable: grad w.r.t. x is Aᵀḡ through a
    #    transpose plan, grad w.r.t. values is gathered per-nnz
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(m.n),
                        dtype=torch.float32, device=op.device)
    xg = x.clone().requires_grad_(True)
    (op @ xg).dot(v).backward()
    vals = torch.as_tensor(m.data, dtype=torch.float32,
                           device=op.device).requires_grad_(True)
    (p.bind(vals) @ x).dot(v).backward()
    print(f"grad shapes: d/dx {tuple(xg.grad.shape)}, "
          f"d/dvalues {tuple(vals.grad.shape)}")

    # 6. SpMM (multi-RHS) through the same operator — used by the
    #    sparse-FFN and serving integrations
    xr = torch.as_tensor(np.random.default_rng(1).standard_normal((m.n, 8)),
                         dtype=torch.float32, device=op.device)
    yr = op @ xr
    print(f"SpMM out: {tuple(yr.shape)}, finite: "
          f"{bool(torch.isfinite(yr).all())}")
    return rel


if __name__ == "__main__":
    main()

"""FEM iterative-solver example — the paper's target workload (§1, §6),
through the operator API.

The port of ``examples/cg_solver.py``.  ``plan`` with
``workload="solver"`` ranks formats on permuted-space hot-loop traffic,
``bind`` fills the values, and ``op.solve`` drives the preconditioned
Krylov loop in the format's execution space.  Forcing ``format=``
reproduces the paper's EHYB-vs-CSR comparison, and the transient-FEM shape
— re-solve with updated values, warm-started from the previous solution —
rides ``update_values`` + ``x0=``.

  PYTHONPATH=src python -m repro_torch.examples.cg_solver [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import elasticity3d
from repro_torch.core.matrices import SparseCSR


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    m = elasticity3d(8)
    print(f"elasticity FEM system: n={m.n} nnz={m.nnz}")
    b = np.random.default_rng(1).standard_normal(m.n).astype(np.float32)

    results = {}
    for fmt in ("auto", "ehyb", "csr"):
        p = api.plan(m, execution=api.ExecutionConfig(
            format=fmt, workload="solver"), device=dev)
        op = p.bind(m)
        bt = torch.as_tensor(b, device=op.device)
        op.solve(bt, precond="spai", tol=1e-6, max_iters=800)     # warm-up
        _sync(op.device)
        t0 = time.perf_counter()
        r = op.solve(bt, precond="spai", tol=1e-6, max_iters=800)
        _sync(op.device)
        dt = time.perf_counter() - t0
        results[fmt] = (dt, r)
        chosen = f" (chose {op.format})" if fmt == "auto" else ""
        print(f"{fmt:5s}{chosen}: {int(r.iters)} iters, residual "
              f"{float(r.residual):.2e}, converged={bool(r.converged)}, "
              f"{dt*1e3:.1f} ms")

    # transient-FEM shape: same pattern, updated values, warm start
    p = api.plan(m, execution=api.ExecutionConfig(format="ehyb",
                                                  workload="solver"),
                 device=dev)
    op = p.bind(m)
    bt = torch.as_tensor(b, device=op.device)
    r_cold = op.solve(bt, precond="spai", tol=1e-6, max_iters=800)
    m2 = SparseCSR(m.n, m.indptr, m.indices, m.data * 1.02)
    op2 = op.update_values(m2)          # one refill, zero re-planning
    r_warm = op2.solve(bt, precond="spai", tol=1e-6, max_iters=800,
                       x0=r_cold.x)
    print(f"value update + warm start: {int(r_warm.iters)} iters "
          f"(cold: {int(r_cold.iters)})")

    e = p.host_build(m)
    print(f"EHYB: {e.n_parts} partitions, in-partition "
          f"{e.in_part_fraction:.1%}, preprocess "
          f"{e.preprocess_seconds['total']*1e3:.1f} ms")
    gain = results["csr"][0] - results["ehyb"][0]
    if gain > 0:
        print(f"solves to amortize preprocessing: "
              f"{e.preprocess_seconds['total'] / gain:.1f}")
    else:
        print("note: on the CPU the plain paths are close; the card's "
              "kernels carry the device story")
    return {fmt: r for fmt, (_, r) in results.items()}, r_cold, r_warm


if __name__ == "__main__":
    main()

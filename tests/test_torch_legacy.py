"""The port's legacy entry points — DeprecationWarning shims over
``repro_torch.api`` (the reference's ``core.spmv``, ``core.solver`` and
``SparseLinear.from_dense`` shims) — the source lint's DEP001 tables, and
the three examples under ``src/repro_torch/examples/`` on the CPU.

Each shim must warn with ``DeprecationWarning`` and return what the
operator-API call it wraps returns on the same inputs (bit for bit where
both run the same plan; the reference's conformance tolerance, 1e-5 of
the largest, where a shim uploads its own tables).  Inputs come from numpy
with a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.analysis.source_lint import _DEPRECATED as J_DEPRECATED
from repro.analysis.source_lint import _DEPRECATED_MODULES as J_DEP_MODULES
from repro_torch import api, core
from repro_torch.analysis.source_lint import (_DEPRECATED, _DEPRECATED_MODULES,
                                              lint_source, run_source_lint)
from repro_torch.core import counters
from repro_torch.core.spmv import cached_spmv_operator
from repro_torch.core.ehyb import build_buckets
from repro_torch.core.matrices import SparseCSR, elasticity3d, poisson3d
from repro_torch.core.solver import precond_inv_diag
from repro_torch.core.sparse_linear import SparseLinear

CPU = "cpu"


@pytest.fixture(scope="module")
def m():
    return poisson3d(8)


def _x(n, k=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) if k is None else (n, k)
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)


def _bound(m, fmt="auto", **kw):
    return api.plan(m, execution=api.ExecutionConfig(format=fmt, **kw),
                    device=CPU).bind(m)


@pytest.mark.parametrize("fmt", ["auto", "csr", "ehyb", "ehyb_packed"])
def test_build_spmv_warns_and_equals_plan_bind(m, fmt):
    x = _x(m.n, 3)
    with pytest.warns(DeprecationWarning, match="build_spmv"):
        op = core.build_spmv(m, fmt, device=CPU)
    ref = _bound(m, fmt)
    assert isinstance(op, core.SpMVOperator) and op.format == ref.format
    assert op.n == m.n and op.nnz == m.nnz and op.dtype == torch.float32
    assert torch.equal(op(x), ref @ x)
    assert torch.equal(op.apply(op.obj, x), ref @ x)
    op2 = op.update_values(SparseCSR(m.n, m.indptr, m.indices, m.data * 3))
    assert isinstance(op2, core.SpMVOperator)
    torch.testing.assert_close(op2(x), 3 * (ref @ x), rtol=1e-5, atol=1e-5)


def test_spmv_warns_and_equals_the_operator(m):
    x = _x(m.n)
    with pytest.warns(DeprecationWarning, match="spmv is deprecated"):
        y = core.spmv(m, x)
    assert torch.equal(y, _bound(m, workload="spmv") @ x)
    # an integer rhs is promoted, not bound as integer tables
    xi = torch.arange(m.n) % 3
    with pytest.warns(DeprecationWarning):
        yi = core.spmv(m, xi)
    assert yi.dtype == torch.float32
    np.testing.assert_allclose(yi.double().numpy(),
                               m.spmv(xi.double().numpy()),
                               rtol=1e-5, atol=1e-5)
    # a bound operator is applied as it is
    op = _bound(m, "csr")
    with pytest.warns(DeprecationWarning):
        assert torch.equal(core.spmv(op, x), op @ x)


def test_cached_spmv_operator_reuses_the_plan(m):
    x = _x(m.n)
    with pytest.warns(DeprecationWarning, match="cached_spmv_operator"):
        a = cached_spmv_operator(m, "ehyb", device=CPU)
    before = counters.snapshot()
    m2 = SparseCSR(m.n, m.indptr, m.indices, m.data * 2)
    with pytest.warns(DeprecationWarning):
        b = cached_spmv_operator(m2, "ehyb", device=CPU)
    after = counters.snapshot()
    assert b.op.plan is a.op.plan          # one plan for the pattern
    for c in ("partition", "build_ehyb"):
        assert after.get(c, 0) == before.get(c, 0), c
    torch.testing.assert_close(b(x), 2 * a(x), rtol=1e-6, atol=1e-6)


def test_spmv_operator_surface(m):
    x = _x(m.n)
    op = _bound(m, "ehyb")
    with pytest.warns(DeprecationWarning, match="SpMVOperator"):
        legacy = core.SpMVOperator(op)
    assert legacy.supports_permuted and legacy.n_pad == op.n_pad
    xn = legacy.to_permuted(x)
    assert torch.equal(xn, op.to_space(x))
    yn = legacy.matvec_permuted(xn)
    assert torch.equal(legacy.from_permuted(yn), op @ x)
    assert torch.equal(legacy.apply_permuted(op.obj, xn), yn)
    assert torch.equal(legacy.matvec(x), op @ x)
    with pytest.warns(DeprecationWarning):
        csr = core.SpMVOperator(_bound(m, "csr"))
    assert csr.apply_permuted is None
    with pytest.raises(ValueError, match="no permuted space"):
        csr.matvec_permuted


def test_csr_spmv_warns_and_equals_the_csr_format(m):
    x = _x(m.n, 2)
    op = _bound(m, "csr")
    with pytest.warns(DeprecationWarning, match="csr_spmv"):
        y = core.csr_spmv(op.obj, x)
    assert torch.equal(y, op @ x)


def test_ehyb_spmv_buckets_warns_and_equals_the_bucketed_format(m):
    x = _x(m.n, 4)
    op = _bound(m, "ehyb_bucketed", partition_method="bfs")
    b = build_buckets(op.plan.host_build(m))
    with pytest.warns(DeprecationWarning, match="ehyb_spmv_buckets"):
        y = core.ehyb_spmv_buckets(b, x)
    torch.testing.assert_close(y, op @ x, rtol=1e-5, atol=1e-5)
    y64 = np.stack([m.spmv(c) for c in x.double().numpy().T], 1)
    np.testing.assert_allclose(y.double().numpy(), y64, rtol=1e-5, atol=1e-4)


def test_solve_warns_and_equals_op_solve():
    m = elasticity3d(4)
    b = _x(m.n, seed=1)
    with pytest.warns(DeprecationWarning, match="solve is deprecated"):
        r = core.solve(m, b, precond="spai", format="ehyb")
    ref = api.plan(m, execution=api.ExecutionConfig(
        format="ehyb", workload="solver"), device=CPU).bind(m).solve(
        b, precond="spai")
    assert bool(r.converged) and int(r.iters) == int(ref.iters)
    assert torch.equal(r.x, ref.x)
    op = _bound(m, "csr")
    with pytest.warns(DeprecationWarning):
        r2 = core.solve(op, b, precond="jacobi")
    assert torch.equal(r2.x, op.solve(b, precond="jacobi").x)
    with pytest.raises(TypeError, match="SparseCSR"):
        with pytest.warns(DeprecationWarning):
            core.solve(np.eye(3), b)


@pytest.mark.parametrize("kind", ["none", "jacobi", "spai"])
def test_precond_for_and_the_preconditioner_table(kind):
    m = elasticity3d(4)
    r = _x(m.n, seed=2).double()
    inv = precond_inv_diag(m, kind)
    want = r if inv is None else torch.as_tensor(inv) * r
    with pytest.warns(DeprecationWarning, match="precond_for"):
        f = core.precond_for(m, kind)
    assert torch.equal(f(r), want)
    assert torch.equal(core.PRECONDITIONERS[kind](m)(r), want)
    op = _bound(m, "ehyb")
    with pytest.warns(DeprecationWarning):
        fp = core.precond_for(m, kind, op=op, space="permuted")
    rn = op.to_space(r.float())
    inv_p = op.precond_inv_permuted(kind)
    want_p = rn if inv_p is None else torch.as_tensor(
        inv_p, dtype=torch.float32) * rn
    assert torch.equal(fp(rn), want_p)
    assert set(core.PRECONDITIONERS) == set(jcore.PRECONDITIONERS)
    with pytest.raises(ValueError, match="permuted execution space"):
        with pytest.warns(DeprecationWarning):
            core.precond_for(m, kind, space="permuted")


def test_from_dense_warns_and_equals_pruned_linear():
    w = np.random.default_rng(3).standard_normal((48, 80))
    x = _x(80, seed=4)[None].repeat(3, 1)
    with pytest.warns(DeprecationWarning, match="from_dense"):
        layer = SparseLinear.from_dense(w, 0.3, format="ehyb",
                                        partition_method="bfs", device=CPU)
    ref = api.pruned_linear(w, 0.3, format="ehyb", partition_method="bfs",
                            device=CPU)
    assert type(layer) is SparseLinear and layer.op.format == "ehyb"
    with torch.no_grad():
        assert torch.equal(layer(x), ref(x))


def test_core_exports_the_references_names():
    assert set(core.__all__) == set(jcore.__all__)
    for name in core.__all__:
        assert getattr(core, name) is not None, name


def test_dep001_tables_hold_the_references_names():
    assert {k: v.replace("repro.", "repro_torch.", 1)
            for k, v in J_DEPRECATED.items()} == _DEPRECATED
    assert {v.replace("repro.", "repro_torch.", 1)
            for v in J_DEP_MODULES} == _DEPRECATED_MODULES
    assert run_source_lint() == []          # the port itself calls none


@pytest.mark.parametrize("name", sorted(_DEPRECATED))
def test_dep001_flags_a_use_outside_the_defining_module(name):
    home = _DEPRECATED[name]
    src = f"from {home} import {name}\n"
    found = lint_source(src, "t.py", "repro_torch.other")
    assert found and {f.rule for f in found} == {"DEP001"}
    assert lint_source(src, "t.py", home) == []
    mod = "import repro_torch.core.dist_spmv\n"
    assert [f.rule for f in lint_source(mod, "t.py", "repro_torch.x")] \
        == ["DEP001"]


def test_example_quickstart_on_the_cpu(capsys):
    from repro_torch.examples import quickstart

    rel = quickstart.main(["--device", "cpu"])
    assert max(rel.values()) < 1e-5
    out = capsys.readouterr().out
    assert "SpMM out: (4096, 8), finite: True" in out


def test_example_cg_solver_on_the_cpu(capsys):
    from repro_torch.examples import cg_solver

    results, cold, warm = cg_solver.main(["--device", "cpu"])
    assert all(bool(r.converged) for r in results.values())
    assert int(warm.iters) <= int(cold.iters)
    assert "value update + warm start" in capsys.readouterr().out


def test_example_serve_lm_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm

    done = serve_lm.main(["--device", "cpu"])
    assert len(done) == 12 and all(len(r.generated) == 8 for r in done)
    assert "served 12 requests" in capsys.readouterr().out


def test_shims_are_not_used_by_the_examples():
    """The examples use ``repro_torch.api`` only: no DEP001 finding."""
    import inspect

    from repro_torch.examples import (cg_solver, quickstart, serve_lm,
                                      sparse_ffn_lm, train_lm)

    for mod in (quickstart, cg_solver, serve_lm, train_lm, sparse_ffn_lm):
        assert lint_source(inspect.getsource(mod), mod.__file__,
                           mod.__name__) == []
    assert dataclasses.is_dataclass(core.SpMVOperator)

"""The port's operator API end to end against the JAX package's.

``repro_torch.api.plan(..., device="cpu").bind(m) @ x`` against
``repro.api.plan(m, execution=ExecutionConfig(format="ehyb",
partition_method="bfs")).bind(m) @ x``, and ``op.solve(b, precond="spai")``
against the JAX solve (the CG + spai rows of ``BENCH_solver.json``: 17, 19
and 6 iterations).  Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import matrices as jmat
from repro_torch import api as tapi
from repro_torch import convert


def port_matrix(name):
    j = jmat.SUITE[name]()
    return convert.csr_from_arrays(j.n, j.indptr, j.indices, j.data), j


def jax_op(jm):
    return japi.plan(jm, execution=japi.ExecutionConfig(
        format="ehyb", partition_method="bfs")).bind(jm)


def port_op(tm, fmt):
    return tapi.plan(tm, execution=tapi.ExecutionConfig(
        format=fmt, partition_method="bfs"), device="cpu").bind(tm)


def rel(y, y_ref):
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    return np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1.0)


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
@pytest.mark.parametrize("name", ["poisson3d_16", "elasticity_8",
                                  "unstruct_4k", "powerlaw_4k"])
def test_plan_bind_apply_matches_jax(name, fmt):
    tm, jm = port_matrix(name)
    x = np.random.default_rng(0).standard_normal(tm.n)
    want = np.asarray(jax_op(jm) @ jnp.asarray(x, jnp.float32))
    op = port_op(tm, fmt)
    assert op.plan.partition_strategy == "bfs"
    assert rel((op @ x).numpy(), want) <= 1e-4
    # the permuted space is the JAX package's (same partition, same perm)
    jo = jax_op(jm)
    np.testing.assert_array_equal(op.obj.perm.numpy(),
                                  np.asarray(jo.obj.perm))
    x_new = op.to_space(x)
    y_new = op.apply(x_new, space=tapi.Space.PERMUTED)
    assert rel(op.from_space(y_new).numpy(), want) <= 1e-4


@pytest.mark.parametrize("name,iters", [("poisson3d_16", 17),
                                        ("poisson27_12", 19),
                                        ("elasticity_8", 6)])
def test_solve_matches_jax(name, iters):
    tm, jm = port_matrix(name)
    b = np.random.default_rng(1).standard_normal(tm.n)
    rj = jax_op(jm).solve(jnp.asarray(b, jnp.float32), precond="spai")
    xj = np.asarray(rj.x)
    assert rj.status == "converged" and abs(int(rj.iters) - iters) <= 1
    for fmt, fused in (("ehyb", False), ("ehyb_packed", False),
                       ("ehyb_packed", True)):
        r = port_op(tm, fmt).solve(b, precond="spai", fused_update=fused)
        assert r.status == "converged", (fmt, fused, r.status)
        assert abs(int(r.iters) - int(rj.iters)) <= 1, (fmt, fused)
        assert np.abs(r.x.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()
        assert float(r.residual) <= 1e-6


def test_solve_status_register_matches_jax():
    """A solve that runs out of iterations reports ``maxiter`` in both."""
    tm, jm = port_matrix("poisson27_12")
    b = np.random.default_rng(2).standard_normal(tm.n)
    rj = jax_op(jm).solve(jnp.asarray(b, jnp.float32), precond="jacobi",
                          max_iters=5, warn=False)
    r = port_op(tm, "ehyb").solve(b, precond="jacobi", max_iters=5)
    assert r.status == rj.status == "maxiter"
    assert int(r.iters) == int(rj.iters) == 5
    assert abs(float(r.residual) - float(rj.residual)) \
        <= 1e-4 * float(rj.residual)


@pytest.mark.parametrize("case", ["breakdown", "diverged", "stagnated"])
def test_cg_guards_match_jax(case):
    """The in-loop sentinels stop both loops at the same step with the same
    status (the JAX ``while_loop`` against the port's masked Python loop)."""
    import torch

    from repro.core.solver import cg as jax_cg
    from repro_torch.core.solver import cg as port_cg

    rng = np.random.default_rng(5)
    q = rng.standard_normal((24, 24))
    a = q @ q.T + 24 * np.eye(24)
    kw = {}
    if case == "breakdown":
        a = -a                          # negative definite: p·Ap < 0
    elif case == "diverged":
        kw = {"div_factor": 1e-3}       # any residual counts as exploding
    else:
        kw = {"stag_window": 1, "stag_rtol": 0.999}
    b = rng.standard_normal(24)
    a32 = jnp.asarray(a, jnp.float32)
    rj = jax_cg(lambda v: a32 @ v, jnp.asarray(b, jnp.float32), tol=1e-6,
                max_iters=50, **kw)
    at = torch.as_tensor(a, dtype=torch.float32)
    r = port_cg(lambda v: at @ v, torch.as_tensor(b, dtype=torch.float32),
                tol=1e-6, max_iters=50, **kw)
    assert r.status == rj.status == case
    assert int(r.iters) == int(rj.iters)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# op.solve(space=...): mirrors tests/test_permuted_space.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
@pytest.mark.parametrize("method", ["cg", "bicgstab"])
@pytest.mark.parametrize("pc", ["none", "jacobi", "spai"])
def test_solve_space_equivalence(fmt, method, pc):
    """The same trajectory in both spaces: iterates agree to fp tolerance
    and iteration counts within one (summation order is the only
    difference)."""
    from repro_torch.core.matrices import poisson3d

    m = poisson3d(6)
    b = np.random.default_rng(0).standard_normal(m.n)
    op = tapi.plan(m, execution=tapi.ExecutionConfig(
        format=fmt, partition_method="bfs"), device="cpu").bind(m)
    kw = dict(method=method, precond=pc, tol=1e-6, max_iters=400)
    r_orig = op.solve(b, space="original", **kw)
    r_perm = op.solve(b, space=tapi.Space.PERMUTED, **kw)
    assert r_orig.status == r_perm.status == "converged"
    assert abs(int(r_orig.iters) - int(r_perm.iters)) <= 1
    x1, x2 = r_orig.x.double().numpy(), r_perm.x.double().numpy()
    assert np.abs(x1 - x2).max() / max(np.abs(x1).max(), 1e-30) < 1e-3


@pytest.mark.parametrize("mat", ["poisson", "unstruct"])
def test_solve_auto_space_is_permuted(mat):
    """``space="auto"`` (the default) runs the permuted space and solves
    the system; the JAX package's auto solve takes as many iterations."""
    from repro_torch.core.matrices import poisson3d, unstructured

    if mat == "poisson":
        tm, jm, method = poisson3d(6), jmat.poisson3d(6), "cg"
    else:
        tm, jm = unstructured(512, 10, seed=9), jmat.unstructured(512, 10,
                                                                 seed=9)
        method = "bicgstab"
    b = np.random.default_rng(1).standard_normal(tm.n)
    op = port_op(tm, "ehyb")
    kw = dict(method=method, precond="jacobi", tol=1e-5, max_iters=1500)
    r = op.solve(b, **kw)
    assert r.status == "converged"
    r_perm = op.solve(b, space="permuted", **kw)
    assert int(r.iters) == int(r_perm.iters)
    assert torch.equal(r.x, r_perm.x)
    ax = tm.spmv(r.x.double().numpy())
    assert np.linalg.norm(ax - b) / np.linalg.norm(b) < 1e-3
    rj = jax_op(jm).solve(jnp.asarray(b, jnp.float32), **kw)
    assert abs(int(r.iters) - int(rj.iters)) <= 1


def test_solve_rejects_an_unknown_space():
    """Every ported format has a permuted space (the JAX package rejects
    ``space="permuted"`` for its flat formats, which the port does not
    carry yet); an unknown space raises."""
    from repro_torch.core.matrices import poisson3d

    m = poisson3d(5)
    op = port_op(m, "ehyb_packed")
    assert op.supports_permuted
    with pytest.raises(ValueError, match="space"):
        op.solve(np.ones(m.n), space="diagonal")

"""The port's reliability path on the CPU, against the JAX package.

Mirrors ``tests/test_reliability.py`` — ``TestGuardedApply``,
``TestSolverGuardrails`` and ``TestSolveFailureReporting`` — on
``repro_torch``: the guard's levels, counters and warnings for native →
unfused → reference under the port's ``chaos``, recovery after the block,
the solver statuses, the failure reporting and the ``SolvePolicy`` ladder.
Where the JAX path runs here it is the oracle: its ``bicgstab`` and ``cg``
on the same matvec and inputs (same status, iterations ±1, x within 1e-4),
its ``ehyb`` (XLA) solve under the same chaos and policy, and the Pallas
interpret kernels ``ehyb_ell_pallas``/``er_pallas`` and
``ehyb_spmv_pallas(..., use_er_kernel=False)`` for the plain versions of
the three kernels this slice ports.  JAX's own ``ehyb_packed`` guard is not
used: on the installed jax its Pallas levels fail on ``pl.load`` and it
degrades.  Otherwise scipy-free float64 numpy is the oracle.  Inputs come
from numpy with a seed.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import matrices as jmat
from repro.core.spmv import EHYBDevice as JEHYBDevice
from repro.core.ehyb import build_ehyb as jax_build_ehyb
from repro.core.solver import bicgstab as jax_bicgstab
from repro.core.solver import cg as jax_cg
from repro.kernels import ehyb_ell_pallas, er_pallas
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.reliability import SolvePolicy as JaxSolvePolicy
from repro.reliability import chaos as jax_chaos
from repro_torch import convert
from repro_torch import kernels as tk
from repro_torch.api import ExecutionConfig, PlanCache, plan
from repro_torch.autotune import registry
from repro_torch.core import counters
from repro_torch.core.ehyb import build_ehyb, pack_staircase
from repro_torch.core.matrices import SUITE, from_coo, poisson3d, unstructured
from repro_torch.core.solver import bicgstab, cg
from repro_torch.kernels import ehyb_spmv as K
from repro_torch.kernels import ops
from repro_torch.reliability import (ReliabilityWarning, SolveFailure,
                                     SolveFailureWarning, SolvePolicy, chaos)
from repro_torch.reliability import guard
from repro_torch.reliability.chaos import epoch

STATIC = ("n", "n_pad", "n_parts", "vec_size", "has_er")


@pytest.fixture(autouse=True)
def _quiet_reliability_warnings():
    """These tests degrade on purpose; assertions use counters, levels and
    statuses, and ``pytest.warns`` where the warning is the point."""
    guard.reset_warned()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReliabilityWarning)
        yield


def _plan(m, fmt="ehyb_packed"):
    return plan(m, execution=ExecutionConfig(format=fmt,
                                             partition_method="bfs"),
                device="cpu")


def _jax_op(m):
    jm = jmat.SparseCSR(m.n, m.indptr, m.indices, m.data)
    return japi.plan(jm, execution=japi.ExecutionConfig(
        format="ehyb", partition_method="bfs")).bind(jm)


def _rel_res(m, x, b) -> float:
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(m.spmv(x) - b) / np.linalg.norm(b))


def _err(y, y_ref) -> float:
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    return float(np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1e-30))


@pytest.fixture
def reached(monkeypatch):
    """Record which SpMV wrapper each apply reaches (on the CPU they still
    compute, through their plain versions)."""
    seen = []
    for name in ("ehyb_fused", "ehyb_packed_fused", "ehyb_ell",
                 "ehyb_ell_packed"):
        real = getattr(K, name)

        def fake(*a, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, fake)
    return seen


# ---------------------------------------------------------------------------
# plain versions of the three kernels of this slice, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,w,r", [(8, 1, 1), (64, 3, 1), (64, 17, 4),
                                   (512, 7, 1), (128, 33, 2)])
@pytest.mark.parametrize("dt,tol", [("float32", 2e-5), ("bfloat16", 1e-2)])
def test_plain_ell_matches_pallas_interpret(v, w, r, dt, tol):
    """``kernels.ehyb_ell`` (the plain version of #4 on the CPU) against
    ``ehyb_ell_pallas`` in interpret mode: the sweep of
    tests/test_kernels.py; one rhs as (P, V) and (P, V, 1), R ≥ 2 as
    (P, V, R).  The random tiles are not width-sorted, so their
    ``col_rows`` says every row is W wide."""
    rng = np.random.default_rng(v * 100 + w + r)
    x = rng.standard_normal((4, v, r)).astype(np.float32)
    vals = (rng.standard_normal((4, v, w))
            * (rng.random((4, v, w)) < 0.7)).astype(np.float32)
    cols = rng.integers(0, v, size=(4, v, w)).astype(np.uint16)
    jdt = getattr(jnp, dt)
    want = np.asarray(ehyb_ell_pallas(
        jnp.asarray(x, jdt), jnp.asarray(vals, jdt), jnp.asarray(cols),
        interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dt)
    tx = torch.as_tensor(x).to(tdt)
    tv = torch.as_tensor(vals).to(tdt)
    tc = torch.as_tensor(cols.astype(np.int32)).to(torch.uint16)
    cr = torch.full((4, w), v, dtype=torch.int32)
    got = tk.ehyb_ell(tx, tv, tc, cr)
    assert got.shape == (4, v, r) and got.dtype == tdt
    assert _err(got.float(), want) <= tol
    if r == 1:
        flat = tk.ehyb_ell(tx[..., 0], tv, tc, cr)
        assert flat.shape == (4, v)
        torch.testing.assert_close(flat, got[..., 0], rtol=0, atol=0)


@pytest.mark.parametrize("rows,w,r", [(8, 1, 1), (64, 9, 1), (256, 5, 4)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_er_matches_pallas_interpret(rows, w, r, dt):
    """``kernels.er`` (the plain version of #6 on the CPU) against
    ``er_pallas`` in interpret mode, the sweep of tests/test_kernels.py, and
    (Rr,) for a 1-D x.  The random tables have no padding: their
    ``er_col_rows`` marks every slot live."""
    rng = np.random.default_rng(rows + w + r)
    n_pad = 512
    x = rng.standard_normal((n_pad, r)).astype(np.float32)
    vals = rng.standard_normal((rows, w)).astype(np.float32)
    cols = rng.integers(0, n_pad, (rows, w)).astype(np.int32)
    jdt = getattr(jnp, dt)
    want = np.asarray(er_pallas(jnp.asarray(x, jdt), jnp.asarray(vals, jdt),
                                jnp.asarray(cols),
                                interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dt)
    tx = torch.as_tensor(x).to(tdt)
    tv = torch.as_tensor(vals).to(tdt)
    every = torch.full((w,), rows, dtype=torch.int32)
    got = tk.er(tx, tv, torch.as_tensor(cols), every)
    assert got.shape == (rows, r) and got.dtype == tdt
    if dt == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    else:
        assert _err(got.float(), want) <= 1e-2
    np.testing.assert_array_equal(
        tk.er(tx[:, 0], tv, torch.as_tensor(cols), every).float().numpy(),
        got[:, 0].float().numpy())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["poisson3d_16", "powerlaw_4k",
                                  "circuit_4k"])
def test_plain_ell_packed_matches_ell_ref_on_unpacked_tables(name, dt):
    """``kernels.ehyb_ell_packed`` (the plain version of #5) on a packed
    build against the JAX ``ehyb_ell_ref`` on the same build's uniform
    tiles (the packed Pallas kernel cannot run on the installed jax)."""
    m = SUITE[name]()
    e = build_ehyb(m, n_parts=8, vec_size=1024 if m.n > 4096 else 512)
    pk = pack_staircase(e)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((e.n_parts, e.vec_size, 1)).astype(np.float32)
    jdt = getattr(jnp, dt)
    want = np.asarray(jref.ehyb_ell_ref(
        jnp.asarray(x, jdt).astype(jnp.float32),
        jnp.asarray(e.ell_vals, jdt).astype(jnp.float32),
        jnp.asarray(e.ell_cols)))
    tdt = getattr(torch, dt)
    got = tk.ehyb_ell_packed(
        torch.as_tensor(x).to(tdt), torch.as_tensor(pk.packed_vals).to(tdt),
        torch.as_tensor(pk.packed_cols.astype(np.int32)).to(torch.uint16),
        torch.as_tensor(pk.col_starts), torch.as_tensor(pk.col_rows))
    assert got.shape == x.shape and got.dtype == tdt
    assert _err(got.float(), want) <= (2e-5 if dt == "float32" else 1e-2)


@pytest.mark.parametrize("gen", ["poisson3d_8", "unstructured_1024"])
def test_unfused_level_matches_jax_interpret(gen, reached):
    """K = 1 with ``use_er_kernel=False`` — the ELL-only kernel plus the
    plain per-partition ER part — against
    ``repro.kernels.ops.ehyb_spmv_pallas(..., use_er_kernel=False,
    interpret=True)`` on the same uniform tiles; ``ehyb_ell_only`` against
    ``ehyb_ell_only_pallas``; and the packed unfused level against the
    fused result."""
    jm = jmat.poisson3d(8) if gen == "poisson3d_8" else \
        jmat.unstructured(1024, 12)
    je = jax_build_ehyb(jm)
    jdev = JEHYBDevice.from_ehyb(je)
    leaves = {f.name: np.asarray(getattr(jdev, f.name))
              for f in dataclasses.fields(jdev)
              if not isinstance(getattr(jdev, f.name), (int, bool, tuple))}
    u = convert.device_container("EHYBDevice", leaves,
                                 {k: getattr(jdev, k) for k in STATIC},
                                 device="cpu", host=je)
    x = np.random.default_rng(3).standard_normal(jm.n).astype(np.float32)
    want = np.asarray(jops.ehyb_spmv_pallas(jdev, jnp.asarray(x),
                                            interpret=True,
                                            use_er_kernel=False))
    got = ops.ehyb_spmv_fused(u, torch.as_tensor(x), use_er_kernel=False)
    assert reached == ["ehyb_ell"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), jm.spmv(x.astype(np.float64)),
                               atol=1e-4 * np.abs(want).max())
    ell_want = np.asarray(jops.ehyb_ell_only_pallas(jdev, jnp.asarray(x),
                                                    interpret=True))
    ell_got = ops.ehyb_ell_only(u, torch.as_tensor(x))
    assert ell_got.shape == (u.n_parts, u.vec_size, 1)
    np.testing.assert_allclose(ell_got.numpy(), ell_want, rtol=1e-5,
                               atol=1e-5)
    tm = convert.csr_from_arrays(jm.n, jm.indptr, jm.indices, jm.data)
    o = _plan(tm).bind(tm).obj
    x_new = torch.as_tensor(np.random.default_rng(4).standard_normal(
        o.n_pad), dtype=torch.float32)
    del reached[:]
    y_unf = ops.ehyb_spmv_packed_permuted(o, x_new, use_er_kernel=False)
    y_fused = ops.ehyb_spmv_packed_permuted(o, x_new)
    assert reached == ["ehyb_ell_packed", "ehyb_packed_fused"]
    torch.testing.assert_close(y_unf, y_fused, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
@pytest.mark.parametrize("name", ["elasticity_8", "powerlaw_4k"])
def test_values_of_bit_identical(name, fmt, dtype):
    """``Plan.values_of`` reads each bound value once, in CSR order, from
    the container it is given — a second bind's container gives the second
    bind's values."""
    m = SUITE[name]()
    p = _plan(m, fmt)
    op = p.bind(m, dtype=dtype)
    v = p.values_of(op.obj)
    assert v.dtype == dtype and v.shape == (m.nnz,)
    assert torch.equal(v, torch.as_tensor(m.data).to(dtype))
    data2 = np.random.default_rng(9).standard_normal(m.nnz)
    op2 = p.bind(data2, dtype=dtype)
    assert torch.equal(p.values_of(op2.obj),
                       torch.as_tensor(data2).to(dtype))
    rows, cols = p.coo()
    np.testing.assert_array_equal(cols, m.indices)
    assert np.array_equal(np.bincount(rows, minlength=m.n), m.row_lengths())


def test_convert_solve_policy_carries_every_field():
    jp = JaxSolvePolicy(max_restarts=3, escalate_method=False,
                        stagnation_window=7, stagnation_rtol=0.01,
                        breakdown_tol=1e-5, divergence_factor=1e9)
    tp = convert.solve_policy(jp)
    assert isinstance(tp, SolvePolicy)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert convert.solve_policy(JaxSolvePolicy()) == SolvePolicy()


# ---------------------------------------------------------------------------
# guarded apply: fallback chain and recovery
# ---------------------------------------------------------------------------

class TestGuardedApply:
    def test_native_failure_falls_back_to_unfused(self, reached):
        m = unstructured(256, 8, seed=31)
        p = _plan(m)
        op = p.bind(m)
        x = np.random.default_rng(1).standard_normal(m.n)
        want = m.to_dense() @ x
        before = counters.snapshot()
        with chaos(kernel_failure=("ehyb_packed:native",)) as cfg:
            y = (op @ x).double().numpy()
            assert p.degraded == {"apply": "ehyb_packed:unfused"}
        assert cfg.injected["kernel:ehyb_packed:native"] >= 1
        assert "ehyb_ell_packed" in reached
        assert "ehyb_packed_fused" not in reached
        np.testing.assert_allclose(y, want, rtol=2e-4, atol=2e-4)
        after = counters.snapshot()
        assert after["guard.level_failed"] == \
            before.get("guard.level_failed", 0) + 1

    def test_all_kernel_levels_fail_falls_back_to_reference(self):
        m = unstructured(256, 8, seed=32)
        p = _plan(m)
        op = p.bind(m)
        x = np.random.default_rng(2).standard_normal(m.n)
        want = m.to_dense() @ x
        before = counters.snapshot()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with chaos(kernel_failure=("ehyb_packed:*",)) as cfg:
                y = (op @ x).double().numpy()
                assert p.degraded == {"apply": "reference"}
                op @ x                  # resolved: no second warning
        assert cfg.injected["kernel:ehyb_packed:native"] >= 1
        assert cfg.injected["kernel:ehyb_packed:unfused"] >= 1
        assert [type(x.message) for x in w] == [ReliabilityWarning]
        assert "reference" in str(w[0].message)
        after = counters.snapshot()
        for name in ("guard.downgrade", "guard.downgrade.ehyb_packed"):
            assert after.get(name, 0) == before.get(name, 0) + 1
        np.testing.assert_allclose(y, want, rtol=2e-4, atol=2e-4)
        # the JAX ehyb (XLA) apply on the same input
        jy = np.asarray(_jax_op(m) @ jnp.asarray(x, jnp.float32))
        assert _err(y, jy) <= 1e-4

    def test_guard_recovers_native_after_chaos_exits(self):
        m = unstructured(256, 8, seed=33)
        p = _plan(m)
        op = p.bind(m)
        x = np.random.default_rng(3).standard_normal(m.n)
        e0 = epoch()
        with chaos(kernel_failure=("ehyb_packed:*",)):
            op @ x
            assert p.degraded
        assert epoch() == e0 + 2          # bumped on entry and on exit
        y = (op @ x).double().numpy()
        assert p.degraded == {}
        assert p._guards["apply"].level == "ehyb_packed:native"
        np.testing.assert_allclose(y, m.to_dense() @ x, rtol=2e-4,
                                   atol=2e-4)

    def test_guarded_solve_converges_on_reference(self):
        """A solve whose kernel levels all fail runs on the reference level
        in the permuted space and lands where the JAX ehyb solve does."""
        m = poisson3d(8)
        p = _plan(m)
        op = p.bind(m)
        b = np.random.default_rng(4).standard_normal(m.n).astype(np.float32)
        with chaos(kernel_failure=("ehyb_packed:*",)) as cfg:
            r = op.solve(b, tol=1e-5)
            assert p.degraded == {"permuted": "reference"}
        assert cfg.injected
        assert r.status == "converged"
        assert _rel_res(m, r.x.numpy(), b) < 1e-4
        rj = _jax_op(m).solve(jnp.asarray(b), tol=1e-5)
        assert abs(int(r.iters) - int(rj.iters)) <= 1
        xj = np.asarray(rj.x)
        assert np.abs(r.x.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()

    def test_solve_on_unfused_level_matches_healthy_solve(self, reached):
        m = SUITE["elasticity_8"]()
        op = _plan(m).bind(m)
        b = np.random.default_rng(5).standard_normal(m.n)
        healthy = op.solve(b, precond="spai")
        del reached[:]
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with chaos(kernel_failure=("ehyb_packed:native",)):
                r = op.solve(b, precond="spai")
                assert op.plan.degraded == {
                    "permuted": "ehyb_packed:unfused"}
        assert [type(x.message) for x in w] == [ReliabilityWarning]
        assert set(reached) == {"ehyb_ell_packed"}
        assert r.status == healthy.status == "converged"
        assert abs(int(r.iters) - int(healthy.iters)) <= 1
        assert _rel_res(m, r.x.numpy(), b) <= 1e-5

    def test_permuted_apply_goes_through_its_own_guard(self):
        m = SUITE["powerlaw_4k"]()
        p = _plan(m)
        op = p.bind(m)
        x = np.random.default_rng(6).standard_normal(m.n)
        x_new = op.to_space(x)
        with chaos(kernel_failure=("ehyb_packed:native",)):
            y_new = op.apply(x_new, space="permuted")
            assert p.degraded == {"permuted": "ehyb_packed:unfused"}
            y = op @ x
            assert p.degraded == {"permuted": "ehyb_packed:unfused",
                                  "apply": "ehyb_packed:unfused"}
        torch.testing.assert_close(op.from_space(y_new), y, rtol=1e-5,
                                   atol=1e-5)
        assert p.degraded == {"permuted": "ehyb_packed:unfused",
                              "apply": "ehyb_packed:unfused"}  # until called
        op @ x
        assert p.degraded == {"permuted": "ehyb_packed:unfused"}

    def test_cpu_plan_probes_only_under_chaos(self, monkeypatch):
        """A CPU plan runs the plain versions: no capability check and no
        probe on a healthy apply; chaos arms the probe."""
        probes = []
        real = guard._Guard._probe
        monkeypatch.setattr(guard._Guard, "_probe", lambda self, *a: (
            probes.append(self.kind), real(self, *a))[1])
        monkeypatch.setattr(ops, "check_cuda_device", lambda d: (
            _ for _ in ()).throw(AssertionError("capability check")))
        m = poisson3d(6)
        op = _plan(m).bind(m)
        x = np.ones(m.n)
        op @ x
        assert probes == []
        with chaos(slow_apply_s=0.0):
            op @ x
        assert probes == ["apply"]
        assert op.plan.degraded == {}

    def test_failing_levels_do_not_loop(self, monkeypatch):
        """A fault that poisons every level (as a sticky CUDA error does)
        surfaces after one pass down the chain instead of retrying."""
        calls = []

        def broken(tag):
            def fn(*a, **kw):
                calls.append(tag)
                raise RuntimeError(f"sticky fault in {tag}")
            return fn

        spec = registry.get_format("ehyb_packed")
        monkeypatch.setitem(registry.FORMATS, "ehyb_packed",
                            dataclasses.replace(
                                spec, apply=broken("native"),
                                fallback=broken("unfused")))
        monkeypatch.setattr(guard, "coo_product", broken("reference"))
        m = poisson3d(6)
        op = _plan(m).bind(m)
        with chaos(slow_apply_s=0.0):      # arm the probe on a CPU plan
            with pytest.raises(RuntimeError, match="sticky fault in "
                               "reference"):
                op @ np.ones(m.n)
        assert calls == ["native", "unfused", "reference"]

    def test_kernel_level_raises_an_organic_failure(self, monkeypatch):
        """On a kernel level only an injected fault moves down the chain: a
        kernel that fails to build or launch raises, as its wrapper does,
        and is never served by a plain level."""
        real_chain = guard.fallback_chain
        monkeypatch.setattr(guard, "fallback_chain", lambda p, kind: [
            (name, fn, name != "reference")
            for name, fn, _ in real_chain(p, kind)])
        monkeypatch.setattr(ops, "check_cuda_device", lambda d: None)

        def broken(*a, **kw):
            raise OSError("nvcc failed")
        spec = registry.get_format("ehyb_packed")
        monkeypatch.setitem(registry.FORMATS, "ehyb_packed",
                            dataclasses.replace(spec, apply=broken))
        m = poisson3d(6)
        op = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                               partition_method="bfs"),
                  device="cpu", cache=PlanCache()).bind(m)
        x = np.random.default_rng(7).standard_normal(m.n)
        before = counters.snapshot()
        with pytest.raises(OSError, match="nvcc failed"):
            op @ x
        assert op.plan.degraded == {}
        after = counters.snapshot()
        for name in ("guard.level_failed", "guard.downgrade"):
            assert after.get(name, 0) == before.get(name, 0)
        with chaos(kernel_failure=("ehyb_packed:native",)) as cfg:
            y = (op @ x).double().numpy()
            assert op.plan.degraded == {"apply": "ehyb_packed:unfused"}
        assert cfg.injected["kernel:ehyb_packed:native"] == 1
        np.testing.assert_allclose(y, m.to_dense() @ x, rtol=2e-4,
                                   atol=2e-4)

    def test_chaos_counts_what_it_delivers_and_does_not_nest(self):
        m = poisson3d(6)
        op = _plan(m, "ehyb").bind(m)
        with chaos(nan_apply=True, slow_apply_s=1e-4) as cfg:
            y = op @ np.ones(m.n)
            with pytest.raises(RuntimeError, match="nest"):
                with chaos():
                    pass
        assert bool(torch.isnan(y).all())
        assert cfg.injected["nan"] == 1 and cfg.injected["slow"] >= 1
        assert bool(torch.isfinite(op @ np.ones(m.n)).all())


# ---------------------------------------------------------------------------
# solver guardrails: the port's cg/bicgstab against the JAX package's
# ---------------------------------------------------------------------------

def _dense_pair(a):
    a32 = jnp.asarray(a, jnp.float32)
    at = torch.as_tensor(np.asarray(a), dtype=torch.float32)
    return (lambda v: a32 @ v), (lambda v: at @ v)


def _jacobi_pair(a):
    d = np.diag(np.asarray(a, np.float64))
    inv = np.where(d == 0, 1.0, 1.0 / np.where(d == 0, 1.0, d))
    ij = jnp.asarray(inv, jnp.float32)
    it = torch.as_tensor(inv, dtype=torch.float32)
    return (lambda r: ij * r), (lambda r: it * r)


def _bicgstab_case(case):
    """(A dense, b, kwargs, precond?) for one BiCGStab case."""
    rng = np.random.default_rng(11)
    if case == "rotation_breakdown":      # r̂·v = 0 at the first step
        return np.array([[0.0, 1.0], [-1.0, 0.0]]), np.array([1.0, 0.0]), \
            {"tol": 1e-8, "max_iters": 50}, False
    if case == "nan_diverged":
        return None, np.ones(8), {"max_iters": 5}, False
    if case == "unstructured_jacobi":     # the JAX test's non-symmetric case
        m = jmat.unstructured(512, 10, seed=9)
        return m.to_dense(), rng.standard_normal(m.n), \
            {"tol": 1e-5, "max_iters": 1000}, True
    if case == "poisson_warm_start":
        m = jmat.poisson3d(6)
        return m.to_dense(), rng.standard_normal(m.n), \
            {"tol": 1e-6, "max_iters": 500,
             "x0": 0.5 * rng.standard_normal(m.n)}, True
    if case == "stagnated":       # any step short of a 1000x cut stalls
        m = jmat.poisson3d(6)
        return m.to_dense(), rng.standard_normal(m.n), \
            {"tol": 1e-6, "max_iters": 400, "stag_window": 1,
             "stag_rtol": 0.999}, True
    if case == "breakdown_tol":           # a loose ρ test trips at once
        m = jmat.poisson3d(6)
        return m.to_dense(), rng.standard_normal(m.n), \
            {"tol": 1e-6, "max_iters": 50, "breakdown_tol": 2.0}, False
    raise ValueError(case)


@pytest.mark.parametrize("case", ["rotation_breakdown", "nan_diverged",
                                  "unstructured_jacobi", "poisson_warm_start",
                                  "stagnated", "breakdown_tol"])
def test_bicgstab_matches_jax(case):
    """Same matvec, same inputs: the same status, iterations within 1 and
    x within 1e-4 of the JAX ``bicgstab`` (``while_loop``) — the port's
    masked Python loop stops where it does."""
    a, b, kw, jacobi = _bicgstab_case(case)
    if a is None:
        mv_j = lambda v: jnp.full_like(v, jnp.nan)      # noqa: E731
        mv_t = lambda v: torch.full_like(v, float("nan"))  # noqa: E731
    else:
        mv_j, mv_t = _dense_pair(a)
    pre_j, pre_t = _jacobi_pair(a) if jacobi else (lambda r: r, None)
    kw_j, kw_t = dict(kw), dict(kw)
    if "x0" in kw:
        kw_j["x0"] = jnp.asarray(kw["x0"], jnp.float32)
        kw_t["x0"] = torch.as_tensor(kw["x0"], dtype=torch.float32)
    rj = jax_bicgstab(mv_j, jnp.asarray(b, jnp.float32), pre_j, **kw_j)
    r = bicgstab(mv_t, torch.as_tensor(b, dtype=torch.float32), pre_t, **kw_t)
    assert r.status == rj.status, (case, r.status, rj.status)
    assert abs(int(r.iters) - int(rj.iters)) <= 1, case
    xj = np.asarray(rj.x)
    assert np.isfinite(r.x.numpy()).all()
    assert np.abs(r.x.numpy() - xj).max() <= 1e-4 * max(np.abs(xj).max(), 1)
    expect = {"rotation_breakdown": "breakdown", "nan_diverged": "diverged",
              "unstructured_jacobi": "converged",
              "poisson_warm_start": "converged", "stagnated": "stagnated",
              "breakdown_tol": "breakdown"}[case]
    assert r.status == expect


class TestSolverGuardrails:
    def test_cg_breakdown_on_indefinite_operator(self):
        a = np.diag([1.0, -1.0])
        mv_j, mv_t = _dense_pair(a)
        rj = jax_cg(mv_j, jnp.asarray([1.0, 1.0], jnp.float32), tol=1e-8,
                    max_iters=50)
        r = cg(mv_t, torch.tensor([1.0, 1.0]), tol=1e-8, max_iters=50)
        assert r.status == rj.status == "breakdown"
        assert not bool(r.converged) and np.isfinite(r.x.numpy()).all()

    def test_nan_matvec_classified_diverged(self):
        b = torch.ones(8)
        bad = lambda v: torch.full_like(v, float("nan"))  # noqa: E731
        for solver in (cg, bicgstab):
            r = solver(bad, b, max_iters=5)
            assert r.status == "diverged"
            assert np.isfinite(r.x.numpy()).all()   # rolled back

    def test_stagnation_detected_at_unreachable_tol(self):
        m = jmat.poisson3d(8)
        b = np.random.default_rng(12).standard_normal(m.n)
        mv_j, mv_t = _dense_pair(m.to_dense())
        pre_j, pre_t = _jacobi_pair(m.to_dense())
        kw = dict(tol=1e-30, max_iters=2000, stag_window=25, stag_rtol=0.05)
        r = cg(mv_t, torch.as_tensor(b, dtype=torch.float32), pre_t, **kw)
        rj = jax_cg(mv_j, jnp.asarray(b, jnp.float32), pre_j, **kw)
        assert r.status == rj.status == "stagnated"
        assert abs(int(r.iters) - int(rj.iters)) <= 1 and int(r.iters) < 2000
        assert _rel_res(m, r.x.numpy(), b) < 1e-4

    def test_bicgstab_on_an_operator_matches_jax_solve(self):
        """``op.solve(b, method="bicgstab")`` on both layouts against the
        JAX ehyb solve (permuted space, spai)."""
        m = SUITE["unstruct_4k"]()
        b = np.random.default_rng(13).standard_normal(m.n)
        rj = _jax_op(m).solve(jnp.asarray(b, jnp.float32), method="bicgstab",
                              precond="spai", tol=1e-6)
        xj = np.asarray(rj.x)
        for fmt in ("ehyb", "ehyb_packed"):
            r = _plan(m, fmt).bind(m).solve(b, method="bicgstab",
                                            precond="spai", tol=1e-6)
            assert r.status == rj.status == "converged"
            assert abs(int(r.iters) - int(rj.iters)) <= 1
            assert np.abs(r.x.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()
            assert _rel_res(m, r.x.numpy(), b) <= 1e-5


# ---------------------------------------------------------------------------
# failure reporting and the escalation ladder
# ---------------------------------------------------------------------------

class TestSolveFailureReporting:
    def test_maxiter_warns_structured(self):
        m = poisson3d(8)
        op = _plan(m, "ehyb").bind(m)
        b = np.random.default_rng(14).standard_normal(m.n)
        with pytest.warns(SolveFailureWarning, match="maxiter"):
            r = op.solve(b, tol=1e-10, max_iters=1)
        assert r.status == "maxiter" and not bool(r.converged)
        with warnings.catch_warnings():
            warnings.simplefilter("error", SolveFailureWarning)
            op.solve(b, tol=1e-10, max_iters=1, warn=False)

    def test_raise_on_failure_carries_result(self):
        m = poisson3d(8)
        op = _plan(m, "ehyb").bind(m)
        b = np.random.default_rng(15).standard_normal(m.n)
        with pytest.raises(SolveFailure) as ei:
            op.solve(b, tol=1e-10, max_iters=1, raise_on_failure=True,
                     warn=False)
        assert ei.value.result is not None
        assert ei.value.result.status == "maxiter"

    @pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
    def test_nan_chaos_escalates_to_reference(self, fmt):
        """All-NaN applies are survived by the policy ladder — restart,
        bicgstab, then the reference CSR solve — as in the JAX package's
        test of the same name, under the same policy and inputs."""
        m = poisson3d(8)
        op = _plan(m, fmt).bind(m)
        b = np.random.default_rng(16).standard_normal(m.n).astype(np.float32)
        policy = JaxSolvePolicy()
        before = counters.snapshot()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with chaos(nan_apply=True) as cfg:
                r = op.solve(b, tol=1e-5, policy=convert.solve_policy(policy))
        assert cfg.injected["nan"] >= 1
        assert r.status == "converged"
        assert _rel_res(m, r.x.numpy(), b) < 1e-4
        msgs = [str(x.message) for x in w
                if issubclass(x.category, ReliabilityWarning)]
        assert any("restart[cg], escalate:bicgstab, escalate:reference"
                   in s for s in msgs)
        after = counters.snapshot()
        for name in ("solver.restart", "solver.escalate_method",
                     "solver.escalate_reference", "solver.recovered"):
            assert after.get(name, 0) == before.get(name, 0) + 1, name
        from repro.core import counters as jcounters

        jop = _jax_op(m)
        jbefore = jcounters.snapshot()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with jax_chaos(nan_apply=True):
                rj = jop.solve(jnp.asarray(b), tol=1e-5, policy=policy)
        jafter = jcounters.snapshot()
        assert rj.status == r.status
        for name in ("solver.restart", "solver.escalate_method",
                     "solver.escalate_reference"):
            assert jafter.get(name, 0) - jbefore.get(name, 0) == 1, name
        xj = np.asarray(rj.x)
        assert np.abs(r.x.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()

    def test_policy_stagnation_status_without_escalation(self):
        m = poisson3d(8)
        op = _plan(m, "ehyb").bind(m)
        b = np.random.default_rng(17).standard_normal(m.n)
        pol = SolvePolicy(max_restarts=0, escalate_method=False,
                          escalate_reference=False, stagnation_window=25,
                          stagnation_rtol=0.05)
        with pytest.warns(SolveFailureWarning, match="stagnated"):
            r = op.solve(b, tol=1e-30, max_iters=2000, policy=pol)
        assert r.status == "stagnated"

    def test_cg_breakdown_skips_restart_and_escalates_to_bicgstab(self):
        """CG breaks down on an indefinite operator; a restart would repeat
        the same trajectory, so the ladder goes straight to BiCGStab."""
        n = 64
        d = np.where(np.arange(n) % 2 == 0, 2.0, -1.0)
        m = from_coo(n, np.arange(n), np.arange(n, dtype=np.int32), d)
        op = _plan(m, "ehyb").bind(m)
        b = np.random.default_rng(18).standard_normal(n)
        before = counters.snapshot()
        r = op.solve(b, precond="none", tol=1e-6, policy=SolvePolicy())
        after = counters.snapshot()
        assert r.status == "converged"
        assert after.get("solver.restart", 0) == before.get(
            "solver.restart", 0)
        assert after["solver.escalate_method"] == before.get(
            "solver.escalate_method", 0) + 1
        np.testing.assert_allclose(r.x.numpy(), b / d, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# every level of every format's fallback chain: NaN reaches the CSR rows
# ---------------------------------------------------------------------------

# levels that read a padded slot (value 0, column 0 of the space they
# gather from) as 0 × x[0]: a NaN there spreads into rows whose CSR product
# never reads it.  The reference's formats do the same (ROADMAP Queue 3,
# "Non-finite x"); every other level gives exactly the CSR product's rows.
_PADDED_READ = {"ehyb:native", "ehyb_bucketed:native",
                "ehyb_packed:unfused", "ell:native", "hyb:native"}


@pytest.mark.parametrize("fmt", sorted(registry.available_formats()))
def test_every_fallback_level_puts_nan_in_the_csr_rows(fmt):
    """For one NaN in x, every level of the format's chain (native,
    unfused where it has one, reference; original and permuted space)
    makes NaN every row whose CSR product reads that column, at K = 1 and
    4.  It makes no other row NaN, except ``dense:native`` (0 × NaN over
    the whole column) and a padded-slot read of the NaN (``_PADDED_READ``
    with the NaN at x_new[0], or original column 0), which only spread."""
    rng = np.random.default_rng(0)
    for name in ("powerlaw_4k", "elasticity_8"):
        m = SUITE[name]()
        rows = np.repeat(np.arange(m.n), m.row_lengths())
        part = "bfs" if registry.get_format(fmt).partitioned else None
        p = plan(m, execution=ExecutionConfig(format=fmt,
                                              partition_method=part),
                 device="cpu", cache=PlanCache())
        op = p.bind(m)
        pad_col = int(op.obj.perm[0]) if op.supports_permuted else 0
        cols = [int(c) for c in rng.choice(np.arange(1, m.n), 2,
                                           replace=False)] + [0, pad_col]
        kinds = ("apply", "permuted") if op.supports_permuted else ("apply",)
        for c in dict.fromkeys(cols):
            want = set(rows[m.indices == c].tolist())
            for k in (1, 4):
                x = torch.as_tensor(rng.standard_normal((m.n, k)),
                                    dtype=torch.float32)
                x[c] = float("nan")
                for kind in kinds:
                    for level, fn, _ in guard.fallback_chain(p, kind):
                        y = fn(op.obj, x) if kind == "apply" else \
                            op.from_space(fn(op.obj, op.to_space(x)))
                        got = set(np.nonzero(
                            torch.isnan(y).any(1).numpy())[0].tolist())
                        what = (name, c, k, kind, level)
                        assert want <= got, what
                        spreads = level == "dense:native" or (
                            level in _PADDED_READ and c == pad_col)
                        if not spreads:
                            assert got == want, what


# ---------------------------------------------------------------------------
# serving: admission control, deadlines, overload, chaos recovery
# (mirrors tests/test_reliability.py's serve tests on the port's engine;
# the degraded run is held to the JAX engine's dense tokens too)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_setup():
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import init_model as jinit_model

    jcfg = jget_config("llama3_2_1b", smoke=True)
    jp = jinit_model(jax.random.PRNGKey(0), jcfg)
    cfg = convert.model_config(jcfg)
    params = convert.lm_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return params, cfg, jp, jcfg


def _engine(serve_setup, **kw):
    from repro_torch.serve import ServeEngine

    params, cfg = serve_setup[:2]
    kw.setdefault("batch", 1)
    kw.setdefault("max_len", 48)
    kw.setdefault("max_prompt", 8)
    return ServeEngine(params, cfg, device="cpu", **kw)


class TestServeAdmissionControl:
    def test_queue_flood_rejects_excess_and_finishes_admitted(
            self, serve_setup):
        from repro_torch.reliability import flood

        eng = _engine(serve_setup, max_queue=2)
        reqs = flood(eng, 6, max_new_tokens=3)
        rejected = [r for r in reqs if r.reject_reason == "queue_full"]
        admitted = [r for r in reqs if r.reject_reason is None]
        assert len(rejected) == 4 and len(admitted) == 2
        assert all(r.done for r in rejected)
        assert eng.health()["stats"]["rejected_queue_full"] == 4
        done = eng.run_until_done()
        finished = [r for r in done if r.reject_reason is None]
        assert sorted(r.uid for r in finished) == \
            sorted(r.uid for r in admitted)
        assert all(len(r.generated) == 3 for r in finished)

    def test_deadline_expires_queued_and_admitted(self, serve_setup):
        from repro_torch.reliability import EnginePolicy
        from repro_torch.serve import Request

        t = [0.0]
        eng = _engine(serve_setup, clock=lambda: t[0],
                      policy=EnginePolicy(default_ttl_s=10.0))
        for i in range(3):
            eng.submit(Request(uid=i, prompt=np.arange(1, 5, dtype=np.int32),
                               max_new_tokens=6))
        done = eng.step()               # admits uid 0 into the single slot
        assert not done
        t[0] = 11.0                     # past every deadline
        done = eng.step()
        expired = {r.uid: r for r in done if r.reject_reason == "deadline"}
        assert sorted(expired) == [0, 1, 2]
        assert expired[0].generated     # admitted one keeps partial tokens
        stats = eng.health()["stats"]
        assert stats["expired_active"] == 1 and stats["expired_queued"] == 2

    def test_per_request_ttl_overrides_policy(self, serve_setup):
        from repro_torch.reliability import EnginePolicy
        from repro_torch.serve import Request

        t = [0.0]
        eng = _engine(serve_setup, clock=lambda: t[0],
                      policy=EnginePolicy(default_ttl_s=1.0))
        eng.submit(Request(uid=0, prompt=np.arange(1, 5, dtype=np.int32),
                           max_new_tokens=2, ttl_s=100.0))
        t[0] = 5.0                      # past policy ttl, inside request ttl
        done = eng.run_until_done()
        assert len(done) == 1 and done[0].reject_reason is None
        assert len(done[0].generated) == 2

    def test_transient_apply_failure_retries_through(self, serve_setup):
        from repro_torch.serve import Request

        eng = _engine(serve_setup)
        eng.submit(Request(uid=0, prompt=np.arange(1, 5, dtype=np.int32),
                           max_new_tokens=3))
        with chaos(serve_apply_failures=2) as cfg:
            done = eng.run_until_done()
        assert cfg.injected["serve:transient"] == 2
        assert len(done) == 1 and len(done[0].generated) == 3
        assert eng.stats["retries"] >= 2
        assert not eng.degraded         # transient: no degradation needed

    def test_sparse_head_failure_degrades_to_dense(self, serve_setup):
        """A persistently failing sparse head must not drop admitted
        requests — the engine degrades to the dense path and produces
        exactly what a dense engine (the port's and the JAX package's)
        would."""
        from repro.serve import Request as JRequest
        from repro.serve import ServeEngine as JServeEngine
        from repro_torch.serve import Request

        prompt = np.arange(1, 7, dtype=np.int32)
        ref = _engine(serve_setup)
        ref.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
        want = ref.run_until_done()[0].generated
        jeng = JServeEngine(serve_setup[2], serve_setup[3], batch=1,
                            max_len=48, max_prompt=8)
        jeng.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=4))
        assert jeng.run_until_done()[0].generated == want

        eng = _engine(serve_setup, sparse_head_density=1.0)
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
        before = counters.snapshot()
        with pytest.warns(ReliabilityWarning, match="degraded"):
            with chaos(fail_sparse_apply=True) as cfg:
                done = eng.run_until_done()
        assert cfg.injected["serve:sparse"] >= 1
        assert eng.degraded and eng.health()["degraded"]
        assert len(done) == 1 and done[0].generated == want
        after = counters.snapshot()
        assert after.get("serve.degraded", 0) == \
            before.get("serve.degraded", 0) + 1
        # the sparse layer survives: restore swaps it back in
        eng.restore_sparse_head()
        assert not eng.degraded
        eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=2))
        done2 = eng.run_until_done()
        assert len(done2) == 1 and len(done2[0].generated) == 2

    def test_non_finite_logits_count_as_a_failure(self, serve_setup):
        """NaN logits from the sparse head (chaos ``nan_apply`` on its
        guarded apply) are a failed step: retried, then served by the
        dense head."""
        from repro_torch.serve import Request

        eng = _engine(serve_setup, sparse_head_density=1.0)
        eng.submit(Request(uid=0, prompt=np.arange(1, 7, dtype=np.int32),
                           max_new_tokens=3))
        with pytest.warns(ReliabilityWarning, match="FloatingPointError"):
            with chaos(nan_apply=True) as cfg:
                done = eng.run_until_done()
        assert cfg.injected["nan"] >= 1 and eng.degraded
        assert len(done) == 1 and len(done[0].generated) == 3

    @pytest.mark.parametrize("fault", ["error", "nan", "injected"])
    def test_card_engine_degrades_only_on_injected_faults(
            self, serve_setup, monkeypatch, fault):
        """On a CUDA engine only an injected fault moves the steps to the
        dense head.  A plain error of the sparse head (a kernel that does
        not build or launch) or its non-finite logits propagate, with no
        retry, and the engine keeps its sparse head.  The engine computes
        here on the CPU with its device set to cuda."""
        eng = _engine(serve_setup, sparse_head_density=1.0)
        eng.device = torch.device("cuda")
        args = (torch.ones((1, 1), dtype=torch.int32), eng.state,
                torch.zeros(1, dtype=torch.int32), eng._head_obj())
        real = eng._head_logits

        def broken(h, head, head_obj=None):
            out = real(h, head, head_obj)
            if head is None:
                return out
            if fault == "error":
                raise RuntimeError("kernel failed to build")
            return torch.full_like(out, float("nan"))

        if fault != "injected":
            monkeypatch.setattr(eng, "_head_logits", broken)
            want = RuntimeError if fault == "error" else FloatingPointError
            with pytest.raises(want):
                eng._guarded_call("decode", *args)
            assert not eng.degraded and eng.stats["retries"] == 0
            assert eng.health()["degraded"] is False
            return
        with pytest.warns(ReliabilityWarning, match="ChaosFault"):
            with chaos(fail_sparse_apply=True) as cfg:
                logits, _ = eng._guarded_call("decode", *args)
        assert cfg.injected["serve:sparse"] >= 1 and eng.degraded
        assert logits.shape[0] == 1 and np.isfinite(logits).all()

    def test_health_snapshot_shape(self, serve_setup):
        eng = _engine(serve_setup, max_queue=4)
        h = eng.health()
        assert h["queue_depth"] == 0 and h["active"] == 0
        assert h["max_queue"] == 4 and h["degraded"] is False
        assert isinstance(h["stats"], dict)
        assert "tune" in h["plan_cache"]

    def test_engine_policy_matches_the_reference(self):
        """The same fields with the same defaults as the reference's."""
        from repro.reliability import EnginePolicy as JEnginePolicy
        from repro_torch.reliability import EnginePolicy

        assert [(f.name, f.default) for f in
                dataclasses.fields(EnginePolicy)] == \
            [(f.name, f.default) for f in dataclasses.fields(JEnginePolicy)]

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

"""Card-only tests of the port's kernels — each kernel against its plain
version on the same CUDA tensors — and of the reliability path on the card
(the guard's levels, the chaos rungs, BiCGStab).

Every test here carries the ``cuda`` marker and skips without a Hopper card
(the decision is taken inside the ``cuda_device`` fixture, never at import).
The file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.api import (ExecutionConfig, PlanCache, ReliabilityWarning,
                             SolvePolicy, chaos, plan)
from repro_torch.core import counters
from repro_torch.core.matrices import SUITE
from repro_torch.kernels import ehyb_spmm as KM
from repro_torch.kernels import ehyb_spmv as K
from repro_torch.kernels import ops, ref
from repro_torch.kernels.solver_step import fused_cg_update
from repro_torch.reliability.guard import reset_warned

# max|Δ| / max(max|y_ref|, 1), kernel against its plain version on the same
# tables: fp32 at the reference's conformance tolerance
# (tests/test_spmv_conformance.py); in bf16 both accumulate in fp32, so they
# may differ only by the rounding of y, a few bf16 ulps (2^-8) of max|y|
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the ELL-only SpMV and ER kernels: fp32 sums over at most a row's entries
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
MATS = ["poisson3d_16", "elasticity_8", "unstruct_4k", "powerlaw_4k",
        "rmat_4k", "circuit_4k"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _rel(y, y_ref):
    y, y_ref = y.double().cpu(), y_ref.double().cpu()
    return float((y - y_ref).abs().max() / max(y_ref.abs().max(), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", MATS)
def test_spmv_kernels_match_plain(cuda_device, name, dtype):
    m = SUITE[name]()
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(m.n),
                        device=cuda_device)
    for fmt in ("ehyb", "ehyb_packed"):
        op = plan(m, execution=ExecutionConfig(
            format=fmt, partition_method="bfs"),
            device=cuda_device).bind(m, dtype=dtype)
        o = op.obj
        x_new = op.to_space(x)
        if fmt == "ehyb":
            n0 = K.ehyb_fused.launches
            y = K.ehyb_fused(x_new, o.ell_vals, o.ell_cols, o.er_p_vals,
                             o.er_p_cols, o.er_p_rows, o.has_er)
            assert K.ehyb_fused.launches == n0 + 1
            y_ref = ref.ehyb_fused_ref(x_new[:, None], o.ell_vals, o.ell_cols,
                                       o.er_p_vals, o.er_p_cols, o.er_p_rows,
                                       o.has_er)[:, 0]
        else:
            op.apply(x_new, space="permuted")   # the guard's probe launches
            n0 = K.ehyb_packed_fused.launches   # once, on the first apply
            y = op.apply(x_new, space="permuted")
            assert K.ehyb_packed_fused.launches == n0 + 1
            y_ref = ref.ehyb_packed_fused_ref(
                x_new[:, None], o.packed_vals, o.packed_cols, o.col_starts,
                o.col_rows, o.er_p_vals, o.er_p_cols, o.er_p_rows,
                o.vec_size, o.has_er)[:, 0]
        torch.cuda.synchronize()
        assert y.dtype == dtype and y.shape == (o.n_pad,)
        assert _rel(y, y_ref) <= TOL[dtype], (name, fmt, dtype)


@pytest.mark.cuda
def test_spmv_kernel_rejects_what_it_does_not_take(cuda_device):
    m = SUITE["poisson3d_16"]()
    op = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                           partition_method="bfs"),
              device=cuda_device).bind(m)
    o = op.obj
    x_new = op.to_space(torch.ones(m.n, device=cuda_device))
    with pytest.raises(NotImplementedError):      # a batch is SpMM's
        K.ehyb_packed_fused(torch.ones((o.n_pad, 2), device=cuda_device),
                            o.packed_vals, o.packed_cols, o.col_starts,
                            o.col_rows, o.er_p_vals, o.er_p_cols, o.er_p_rows,
                            vec_size=o.vec_size)
    with pytest.raises(NotImplementedError):      # ELL-only: one rhs too
        K.ehyb_ell_packed(torch.ones((o.n_parts, o.vec_size, 2),
                                     device=cuda_device),
                          o.packed_vals, o.packed_cols, o.col_starts,
                          o.col_rows)
    # the K = 1 unfused level (ELL-only kernel + plain ER part) equals the
    # fused result
    n0 = K.ehyb_ell_packed.launches
    y_unf = ops.ehyb_spmv_packed_permuted(o, x_new, use_er_kernel=False)
    assert K.ehyb_ell_packed.launches == n0 + 1
    torch.testing.assert_close(y_unf, op.apply(x_new, space="permuted"),
                               rtol=1e-5, atol=1e-5)
    op64 = op.plan.bind(m, dtype=torch.float64)
    x64 = torch.ones(m.n, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):                # the kernels take no fp64
        ops.ehyb_spmv_packed(op64.obj, x64)
    with pytest.raises(TypeError):
        K.er(x_new.double(), op64.obj.er_vals, op64.obj.er_cols)
    with pytest.raises(TypeError):                # and the guard does not
        op64 @ torch.ones(m.n, device=cuda_device)  # serve it plainly
    assert op.plan.degraded == {}


@pytest.mark.cuda
def test_cg_update_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    n = 100_003                       # not a multiple of the block
    x, r, p, ap, minv = (torch.as_tensor(rng.standard_normal(n),
                                         dtype=torch.float32,
                                         device=cuda_device)
                         for _ in range(5))
    alpha = torch.tensor(0.37, device=cuda_device)
    got = fused_cg_update(x, r, p, ap, minv, alpha)
    want = ref.cg_update_ref(x, r, p, ap, minv, alpha)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    for g, w in zip(got[3:], want[3:]):
        assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))
    again = fused_cg_update(x, r, p, ap, minv, alpha)
    assert float(again[3]) == float(got[3])       # deterministic reduction


@pytest.mark.cuda
def test_solve_fused_matches_plain_update(cuda_device):
    m = SUITE["elasticity_8"]()
    b = np.random.default_rng(1).standard_normal(m.n)
    op = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                           partition_method="bfs"),
              device=cuda_device).bind(m)
    n0 = fused_cg_update.launches
    rf = op.solve(b, precond="spai")
    assert fused_cg_update.launches > n0
    rp = op.solve(b, precond="spai", fused_update=False)
    assert rf.status == rp.status == "converged"
    assert abs(int(rf.iters) - int(rp.iters)) <= 1
    x = rf.x.double().cpu().numpy()
    assert np.linalg.norm(m.spmv(x) - b) / np.linalg.norm(b) <= 1e-5


def _spmm_cases(op, x_new, rhs_chunk=None):
    """(name, wrapper, kernel result, plain result) for the four SpMM
    kernels on ``op``'s tables (uniform ones from an ``ehyb`` operator,
    packed ones from an ``ehyb_packed`` one)."""
    o = op.obj
    k = x_new.shape[1]
    x_parts = x_new.reshape(o.n_parts, o.vec_size, k)
    if op.format == "ehyb":
        return [
            ("ehyb_fused_spmm", KM.ehyb_fused_spmm,
             lambda: KM.ehyb_fused_spmm(x_new, o.ell_vals, o.ell_cols,
                                        o.er_p_vals, o.er_p_cols, o.er_p_rows,
                                        rhs_chunk=rhs_chunk),
             lambda: ref.ehyb_fused_ref(x_new, o.ell_vals, o.ell_cols,
                                        o.er_p_vals, o.er_p_cols,
                                        o.er_p_rows)),
            ("ehyb_ell_spmm", KM.ehyb_ell_spmm,
             lambda: KM.ehyb_ell_spmm(x_parts, o.ell_vals, o.ell_cols,
                                      rhs_chunk=rhs_chunk),
             lambda: ref.ehyb_ell_ref(x_parts, o.ell_vals, o.ell_cols))]
    return [
        ("ehyb_packed_fused_spmm", KM.ehyb_packed_fused_spmm,
         lambda: KM.ehyb_packed_fused_spmm(
             x_new, o.packed_vals, o.packed_cols, o.col_starts, o.col_rows,
             o.er_p_vals, o.er_p_cols, o.er_p_rows, vec_size=o.vec_size,
             rhs_chunk=rhs_chunk),
         lambda: ref.ehyb_packed_fused_ref(
             x_new, o.packed_vals, o.packed_cols, o.col_starts, o.col_rows,
             o.er_p_vals, o.er_p_cols, o.er_p_rows, o.vec_size)),
        ("ehyb_ell_packed_spmm", KM.ehyb_ell_packed_spmm,
         lambda: KM.ehyb_ell_packed_spmm(x_parts, o.packed_vals,
                                         o.packed_cols, o.col_starts,
                                         o.col_rows, rhs_chunk=rhs_chunk),
         lambda: ref.ehyb_ell_packed_ref(x_parts, o.packed_vals,
                                         o.packed_cols, o.col_starts,
                                         o.col_rows))]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 17, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", MATS)
def test_spmm_kernels_match_plain(cuda_device, name, dtype, k):
    m = SUITE[name]()
    x = torch.as_tensor(np.random.default_rng(k).standard_normal((m.n, k)),
                        device=cuda_device)
    for fmt in ("ehyb", "ehyb_packed"):
        op = plan(m, execution=ExecutionConfig(
            format=fmt, partition_method="bfs", k=k),
            device=cuda_device).bind(m, dtype=dtype)
        x_new = op.to_space(x)
        for rhs_chunk in (None, 3):
            for kname, wrapper, run, plain in _spmm_cases(op, x_new,
                                                          rhs_chunk):
                n0 = wrapper.launches
                y = run()
                assert wrapper.launches == n0 + 1
                y_ref = plain()
                torch.cuda.synchronize()
                assert y.dtype == dtype and y.shape == y_ref.shape
                assert _rel(y, y_ref) <= TOL[dtype], (name, kname, k,
                                                      rhs_chunk)


@pytest.mark.cuda
def test_batched_apply_routes_to_spmm_and_matches_columns(cuda_device):
    m = SUITE["elasticity_8"]()
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((m.n, 6)),
                        dtype=torch.float32, device=cuda_device)
    op = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                           partition_method="bfs", k=6),
              device=cuda_device).bind(m)
    n0 = KM.ehyb_packed_fused_spmm.launches
    y = op @ x
    assert KM.ehyb_packed_fused_spmm.launches == n0 + 1
    cols = torch.stack([op @ x[:, j] for j in range(6)], dim=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, cols, rtol=1e-5, atol=1e-5)
    want = m.to_dense() @ x.double().cpu().numpy()
    assert _rel(y, torch.as_tensor(want)) <= 1e-4
    # a strided (transposed) batch is made contiguous before the launch
    x_new = op.to_space(x)
    xt = x_new.T.contiguous().T
    assert not xt.is_contiguous()
    torch.testing.assert_close(op.apply(xt, space="permuted"),
                               op.apply(x_new, space="permuted"))
    # the unfused level: ELL-only kernel + plain ER part
    n1 = KM.ehyb_ell_packed_spmm.launches
    y_unfused = ops.ehyb_spmv_packed_permuted(op.obj, x_new,
                                              use_er_kernel=False)
    assert KM.ehyb_ell_packed_spmm.launches == n1 + 1
    torch.testing.assert_close(op.from_space(y_unfused), y, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_spmm_kernels_reject_what_they_do_not_take(cuda_device):
    m = SUITE["poisson3d_16"]()
    p = plan(m, execution=ExecutionConfig(format="ehyb",
                                          partition_method="bfs"),
             device=cuda_device)
    o = p.bind(m).obj
    x = torch.ones((o.n_pad, 4), device=cuda_device)
    tables = (o.ell_vals, o.ell_cols, o.er_p_vals, o.er_p_cols, o.er_p_rows)
    o64 = p.bind(m, dtype=torch.float64).obj
    with pytest.raises(TypeError):               # fp64 tables
        KM.ehyb_fused_spmm(x.double(), o64.ell_vals, o64.ell_cols,
                           o64.er_p_vals, o64.er_p_cols, o64.er_p_rows)
    with pytest.raises(TypeError):               # x not in the tables' dtype
        KM.ehyb_fused_spmm(x.bfloat16(), *tables)
    with pytest.raises(ValueError):              # not (n_pad, K)
        KM.ehyb_fused_spmm(x[:-1], *tables)
    with pytest.raises(ValueError):              # ELL-only takes (P, V, K)
        KM.ehyb_ell_spmm(x, o.ell_vals, o.ell_cols)
    with pytest.raises(TypeError):               # uint16 local columns only
        KM.ehyb_ell_spmm(x.reshape(o.n_parts, o.vec_size, 4), o.ell_vals,
                         o.ell_cols.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", MATS)
def test_ell_and_er_kernels_match_plain(cuda_device, name, dtype):
    """#4 ``ehyb_ell``, #5 ``ehyb_ell_packed`` and #6 ``er`` against their
    plain versions on the same tables, and ELL-only + ER partials scattered
    by ``er_row_idx`` against the fused kernel."""
    m = SUITE[name]()
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(m.n),
                        device=cuda_device)
    p = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                          partition_method="bfs"),
             device=cuda_device)
    op = p.bind(m, dtype=dtype)
    u = plan(m, execution=ExecutionConfig(format="ehyb",
                                          partition_method="bfs"),
             device=cuda_device).bind(m, dtype=dtype).obj
    o = op.obj
    x_new = op.to_space(x)
    xp = x_new.reshape(o.n_parts, o.vec_size)
    stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
    cases = [
        (K.ehyb_ell, lambda: K.ehyb_ell(xp, u.ell_vals, u.ell_cols),
         lambda: ref.ehyb_ell_ref(xp[..., None], u.ell_vals,
                                  u.ell_cols)[..., 0]),
        (K.ehyb_ell_packed, lambda: K.ehyb_ell_packed(xp, *stair),
         lambda: ref.ehyb_ell_packed_ref(xp[..., None], *stair)[..., 0]),
        (K.er, lambda: K.er(x_new, o.er_vals, o.er_cols),
         lambda: ref.er_ref(x_new[:, None], o.er_vals, o.er_cols)[:, 0]),
    ]
    for wrapper, run, plain in cases:
        n0 = wrapper.launches
        y = run()
        assert wrapper.launches == n0 + 1
        y_ref = plain()
        torch.cuda.synchronize()
        assert y.dtype == dtype and y.shape == y_ref.shape
        assert _rel(y, y_ref) <= REL_TOL[dtype], (name, wrapper.__name__,
                                                   dtype)
    xr = torch.stack([x_new, -x_new, 2 * x_new, x_new], dim=1)
    assert _rel(K.er(xr, o.er_vals, o.er_cols),
                ref.er_ref(xr, o.er_vals, o.er_cols)) <= REL_TOL[dtype]
    if dtype == torch.float32:
        y = K.ehyb_ell_packed(xp, *stair).reshape(-1).clone()
        y.index_add_(0, o.er_row_idx.long(), K.er(x_new, o.er_vals,
                                                  o.er_cols))
        fused = op.apply(x_new, space="permuted")
        assert _rel(y, fused) <= 1e-5, name


@pytest.mark.cuda
def test_guard_resolves_native_on_the_card(cuda_device):
    m = SUITE["elasticity_8"]()
    p = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                          partition_method="bfs"),
             device=cuda_device, cache=PlanCache())
    op = p.bind(m)
    before = counters.snapshot().get("guard.downgrade", 0)
    n0 = K.ehyb_packed_fused.launches
    y = op @ np.ones(m.n)
    op.apply(op.to_space(np.ones(m.n)), space="permuted")
    torch.cuda.synchronize()
    assert p.degraded == {}
    assert p._guards["apply"].level == "ehyb_packed:native"
    assert p._guards["permuted"].level == "ehyb_packed:native"
    assert K.ehyb_packed_fused.launches == n0 + 4    # 2 probes, 2 applies
    assert counters.snapshot().get("guard.downgrade", 0) == before
    np.testing.assert_allclose(y.double().cpu().numpy(),
                               m.spmv(np.ones(m.n)), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_chaos_rungs_on_the_card(cuda_device):
    """Each rung on the card: native fails -> the unfused level launches
    #5 and not #2; every kernel level fails -> the reference level on the
    card; NaN output -> the solve ladder ends on the reference solve."""
    m = SUITE["elasticity_8"]()
    p = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                          partition_method="bfs"),
             device=cuda_device, cache=PlanCache())
    op = p.bind(m)
    b = np.random.default_rng(1).standard_normal(m.n)
    healthy = op.solve(b, precond="spai")
    reset_warned()
    n_fused, n_ell = K.ehyb_packed_fused.launches, K.ehyb_ell_packed.launches
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with chaos(kernel_failure=("ehyb_packed:native",)) as cfg:
            r = op.solve(b, precond="spai")
            assert p.degraded == {"permuted": "ehyb_packed:unfused"}
    assert cfg.injected["kernel:ehyb_packed:native"] == 1
    assert K.ehyb_packed_fused.launches == n_fused
    assert K.ehyb_ell_packed.launches > n_ell
    assert [x.category for x in w] == [ReliabilityWarning]
    assert r.status == "converged"
    assert abs(int(r.iters) - int(healthy.iters)) <= 1
    x = np.ones(m.n)
    with chaos(kernel_failure=("ehyb_packed:*",)) as cfg:
        y = op @ x
        assert p.degraded["apply"] == "reference"
    assert y.device.type == "cuda"
    np.testing.assert_allclose(y.double().cpu().numpy(), m.spmv(x),
                               rtol=1e-4, atol=1e-4)
    op @ x
    op.apply(op.to_space(x), space="permuted")
    assert p.degraded == {}             # both guards back on native
    before = counters.snapshot()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with chaos(nan_apply=True) as cfg:
            r = op.solve(b, precond="spai", policy=SolvePolicy())
    assert cfg.injected["nan"] >= 1
    after = counters.snapshot()
    assert after["solver.escalate_reference"] == \
        before.get("solver.escalate_reference", 0) + 1
    assert r.status == "converged" and r.x.device.type == "cuda"
    xs = r.x.double().cpu().numpy()
    assert np.linalg.norm(m.spmv(xs) - b) / np.linalg.norm(b) <= 1e-5


@pytest.mark.cuda
def test_bicgstab_on_the_card_matches_the_cpu_port(cuda_device):
    m = SUITE["unstruct_4k"]()
    b = np.random.default_rng(2).standard_normal(m.n)
    ex = ExecutionConfig(format="ehyb_packed", partition_method="bfs")
    r_cpu = plan(m, execution=ex, device="cpu").bind(m).solve(
        b, method="bicgstab", precond="spai")
    r = plan(m, execution=ex, device=cuda_device).bind(m).solve(
        b, method="bicgstab", precond="spai")
    assert r.status == r_cpu.status == "converged"
    assert abs(int(r.iters) - int(r_cpu.iters)) <= 1
    x, x_cpu = r.x.double().cpu().numpy(), r_cpu.x.double().numpy()
    assert np.abs(x - x_cpu).max() <= 1e-4 * np.abs(x_cpu).max()
    assert np.linalg.norm(m.spmv(x) - b) / np.linalg.norm(b) <= 1e-5

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
from repro_torch.core.matrices import SUITE, from_coo
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
            y = K.ehyb_fused(x_new, o.ell_vals, o.ell_cols, o.col_rows,
                             o.er_stream(), o.has_er)
            assert K.ehyb_fused.launches == n0 + 1
            y_ref = ref.ehyb_fused_stream_ref(
                x_new[:, None], o.ell_vals, o.ell_cols, o.col_rows,
                o.er_stream(), o.has_er)[:, 0]
            # the padded tiles' plain version computes the same product
            y_tiles = ref.ehyb_fused_ref(
                x_new[:, None], o.ell_vals, o.ell_cols, o.er_p_vals,
                o.er_p_cols, o.er_p_rows, o.has_er)[:, 0]
        else:
            op.apply(x_new, space="permuted")   # the guard's probe launches
            n0 = K.ehyb_packed_fused.launches   # once, on the first apply
            y = op.apply(x_new, space="permuted")
            assert K.ehyb_packed_fused.launches == n0 + 1
            stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
            y_ref = ref.ehyb_packed_fused_stream_ref(
                x_new[:, None], *stair, o.er_stream(), o.vec_size,
                o.has_er)[:, 0]
            y_tiles = ref.ehyb_packed_fused_ref(
                x_new[:, None], *stair, o.er_p_vals, o.er_p_cols,
                o.er_p_rows, o.vec_size, o.has_er)[:, 0]
        torch.cuda.synchronize()
        assert y.dtype == dtype and y.shape == (o.n_pad,)
        assert _rel(y, y_ref) <= TOL[dtype], (name, fmt, dtype)
        assert _rel(y, y_tiles) <= TOL[dtype], (name, fmt, dtype)


def _spmv_launches(m, dtype, device):
    """{kernel: (wrapper, call, plain call)} for #1, #2, #4 and #5 on
    ``m``'s uniform and packed builds at a random permuted-space x."""
    ex = dict(partition_method="bfs")
    op = plan(m, execution=ExecutionConfig(format="ehyb_packed", **ex),
              device=device).bind(m, dtype=dtype)
    u = plan(m, execution=ExecutionConfig(format="ehyb", **ex),
             device=device).bind(m, dtype=dtype).obj
    o = op.obj
    x_new = op.to_space(torch.as_tensor(
        np.random.default_rng(7).standard_normal(m.n), device=device))
    xp = x_new.reshape(o.n_parts, o.vec_size)
    stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
    return o, u, {
        "ehyb_fused": (
            K.ehyb_fused,
            lambda: K.ehyb_fused(x_new, u.ell_vals, u.ell_cols, u.col_rows,
                                 u.er_stream(), u.has_er),
            lambda: ref.ehyb_fused_stream_ref(
                x_new[:, None], u.ell_vals, u.ell_cols, u.col_rows,
                u.er_stream(), u.has_er)[:, 0]),
        "ehyb_packed_fused": (
            K.ehyb_packed_fused,
            lambda: K.ehyb_packed_fused(x_new, *stair, o.er_stream(),
                                        vec_size=o.vec_size,
                                        has_er=o.has_er),
            lambda: ref.ehyb_packed_fused_stream_ref(
                x_new[:, None], *stair, o.er_stream(), o.vec_size,
                o.has_er)[:, 0]),
        "ehyb_ell": (
            K.ehyb_ell,
            lambda: K.ehyb_ell(xp, u.ell_vals, u.ell_cols, u.col_rows),
            lambda: ref.ehyb_ell_ref(xp[..., None], u.ell_vals,
                                     u.ell_cols, u.col_rows)[..., 0]),
        "ehyb_ell_packed": (
            K.ehyb_ell_packed, lambda: K.ehyb_ell_packed(xp, *stair),
            lambda: ref.ehyb_ell_packed_ref(xp[..., None], *stair)[..., 0]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", MATS)
def test_spmv_kernels_are_bit_reproducible(cuda_device, name, dtype):
    """Two launches of #1, #2, #4 and #5 on the same inputs give the same
    bits: every sum runs in a fixed order, with no float atomics."""
    _, _, cases = _spmv_launches(SUITE[name](), dtype, cuda_device)
    for kname, (_, run, _) in cases.items():
        a, b = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(a, b), (name, kname, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["powerlaw_4k", "circuit_4k"])
def test_fused_kernels_on_er_heavy_matrices(cuda_device, name, dtype):
    """ER-heavy builds: rows at the full ER width (hundreds of entries, far
    past one unrolled step of a lane group) and partitions that own no ER
    row; #1 and #2 against their plain versions."""
    m = SUITE[name]()
    o, u, cases = _spmv_launches(m, dtype, cuda_device)
    lens = o.er_s_row_ptr.diff()
    e = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                          partition_method="bfs"),
             device=cuda_device).host_build(m)
    assert int(lens.max()) == e.er_width > 32 * 4
    assert bool((o.er_s_part_ptr.diff() == 0).any())
    for kname in ("ehyb_fused", "ehyb_packed_fused"):
        wrapper, run, plain = cases[kname]
        n0 = wrapper.launches
        y = run()
        assert wrapper.launches == n0 + 1
        y_ref = plain()
        torch.cuda.synchronize()
        assert _rel(y, y_ref) <= TOL[dtype], (name, kname, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", MATS)
def test_ell_kernels_with_row_widths_match_plain(cuda_device, name, dtype):
    """#4 and #5 against their plain versions at the ELL-only tolerance;
    #4 also with a ``col_rows`` that makes every row W wide, so that it
    reads the padded tail (zeros) as well."""
    _, u, cases = _spmv_launches(SUITE[name](), dtype, cuda_device)
    for kname in ("ehyb_ell", "ehyb_ell_packed"):
        wrapper, run, plain = cases[kname]
        n0 = wrapper.launches
        y = run()
        assert wrapper.launches == n0 + 1
        torch.cuda.synchronize()
        assert _rel(y, plain()) <= REL_TOL[dtype], (name, kname, dtype)
    xp = torch.randn((u.n_parts, u.vec_size), device=cuda_device).to(dtype)
    want = ref.ehyb_ell_ref(xp[..., None], u.ell_vals, u.ell_cols,
                            u.col_rows)[..., 0]
    for col_rows in (u.col_rows, torch.full_like(u.col_rows, u.vec_size)):
        y = K.ehyb_ell(xp, u.ell_vals, u.ell_cols, col_rows)
        torch.cuda.synchronize()
        assert _rel(y, want) <= REL_TOL[dtype], (name, dtype)


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
                            o.col_rows, o.er_stream(), vec_size=o.vec_size)
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
        K.er(x_new.double(), op64.obj.er_vals, op64.obj.er_cols,
             op64.obj.er_col_rows)
    with pytest.raises(TypeError):                # and the guard does not
        op64 @ torch.ones(m.n, device=cuda_device)  # serve it plainly
    assert op.plan.degraded == {}


def _cg_inputs(n, dtype, device, seed=3, offset=0):
    """x, r, p, ap (dtype) and a positive fp32 minv of n elements, each a
    view ``offset`` elements into its own buffer, and alpha."""
    rng = np.random.default_rng(seed)

    def vec(dt, positive=False):
        v = (rng.uniform(0.5, 1.5, n + offset) if positive
             else rng.standard_normal(n + offset))
        return torch.as_tensor(v, dtype=dt, device=device)[offset:]

    vecs = [vec(dtype) for _ in range(4)] + [vec(torch.float32, True)]
    return vecs, torch.tensor(0.37, device=device)


def _check_cg_step(got, want, dtype):
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        else:
            assert _rel(g, w) <= 1e-2
    for g, w in zip(got[3:], want[3:]):
        assert g.dtype == torch.float32 and g.shape == ()
        assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 7, 1023, 100_003, 789_888])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cg_update_kernel_matches_plain(cuda_device, dtype, n, offset):
    """Every length class (one element, a partial unit, less than a block,
    a tail unit, the solve's n_pad) and both instances: offset 1 puts every
    input's base pointer off 16 bytes, so the scalar-load instance runs."""
    vecs, alpha = _cg_inputs(n, dtype, cuda_device, offset=offset)
    assert all((v.data_ptr() % 16 == 0) == (offset == 0) for v in vecs)
    got = fused_cg_update(*vecs, alpha)
    want = ref.cg_update_ref(*vecs, alpha)
    torch.cuda.synchronize()
    _check_cg_step(got, want, dtype)
    again = fused_cg_update(*vecs, alpha)
    assert torch.equal(torch.stack(again[3:]), torch.stack(got[3:]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cg_update_dots_bit_identical_across_launches_and_streams(
        cuda_device, dtype):
    """50 launches on fresh data, each held against the plain version (a
    last block that read a stale partial would be off) and repeated on a
    second stream while the first stream runs another launch: the same
    bits every time."""
    n = 789_888
    side = torch.cuda.Stream(cuda_device)
    for i in range(50):
        vecs, alpha = _cg_inputs(n, dtype, cuda_device, seed=100 + i)
        other, _ = _cg_inputs(n, dtype, cuda_device, seed=1000 + i)
        torch.cuda.synchronize()
        got = fused_cg_update(*vecs, alpha)
        with torch.cuda.stream(side):
            on_side = fused_cg_update(*vecs, alpha)
        busy = fused_cg_update(*other, alpha)     # concurrent, own ticket
        again = fused_cg_update(*vecs, alpha)
        torch.cuda.synchronize()
        dots = torch.stack(got[3:])
        assert torch.equal(torch.stack(on_side[3:]), dots)
        assert torch.equal(torch.stack(again[3:]), dots)
        if i % 10 == 0:
            _check_cg_step(got, ref.cg_update_ref(*vecs, alpha), dtype)
            _check_cg_step(busy, ref.cg_update_ref(*other, alpha), dtype)
        else:
            want = ref.cg_update_ref(*vecs, alpha)
            for g, w in zip(got[3:], want[3:]):
                assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))


@pytest.mark.cuda
@pytest.mark.parametrize("value", [float("nan"), float("inf")])
@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("name", ["x", "r", "p", "ap", "minv"])
@pytest.mark.parametrize("n", [100_003, 789_888])
def test_cg_update_nonfinite_reaches_the_outputs(cuda_device, n, name,
                                                 where, value):
    """A NaN or Inf in the first element (a 16-byte load) or the last (the
    scalar tail at n = 100,003, a vector at 789,888) reaches what it feeds,
    as in the plain version: r and ap make r' and so rr non-finite (the
    solver's divergence guard reads rr), minv makes z' and rz non-finite,
    x and p make that element of x' non-finite."""
    vecs, alpha = _cg_inputs(n, torch.float32, cuda_device)
    k = {"x": 0, "r": 1, "p": 2, "ap": 3, "minv": 4}[name]
    i = 0 if where == "first" else n - 1
    vecs[k][i] = value
    got = fused_cg_update(*vecs, alpha)
    want = ref.cg_update_ref(*vecs, alpha)
    torch.cuda.synchronize()
    if name in ("r", "ap"):
        assert not torch.isfinite(got[4]) and not torch.isfinite(got[3])
        assert not torch.isfinite(got[1][i])
    elif name == "minv":
        assert not torch.isfinite(got[3]) and torch.isfinite(got[4])
        assert not torch.isfinite(got[2][i])
    else:
        assert not torch.isfinite(got[0][i])
        assert torch.isfinite(got[3]) and torch.isfinite(got[4])
    for g, w in zip(got, want):               # the same finiteness pattern
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))


@pytest.mark.cuda
def test_cg_update_is_one_device_kernel_a_call(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vecs, alpha = _cg_inputs(789_888, torch.float32, cuda_device)
    fused_cg_update(*vecs, alpha)          # build, ticket made
    torch.cuda.synchronize()
    n0 = fused_cg_update.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fused_cg_update(*vecs, alpha)
        torch.cuda.synchronize()
    assert fused_cg_update.launches == n0 + 5
    device_events = {ev.key: ev.count for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA
                     and not ev.key.startswith("Activity Buffer")}
    assert sum(device_events.values()) == 5, device_events
    assert all("cg_update_kernel" in k for k in device_events), device_events


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
                                        o.col_rows, o.er_stream(),
                                        rhs_chunk=rhs_chunk),
             lambda: ref.ehyb_fused_stream_ref(x_new, o.ell_vals, o.ell_cols,
                                               o.col_rows, o.er_stream())),
            ("ehyb_ell_spmm", KM.ehyb_ell_spmm,
             lambda: KM.ehyb_ell_spmm(x_parts, o.ell_vals, o.ell_cols,
                                      o.col_rows, rhs_chunk=rhs_chunk),
             lambda: ref.ehyb_ell_ref(x_parts, o.ell_vals, o.ell_cols,
                                      o.col_rows))]
    return [
        ("ehyb_packed_fused_spmm", KM.ehyb_packed_fused_spmm,
         lambda: KM.ehyb_packed_fused_spmm(
             x_new, o.packed_vals, o.packed_cols, o.col_starts, o.col_rows,
             o.er_stream(), vec_size=o.vec_size, rhs_chunk=rhs_chunk),
         lambda: ref.ehyb_packed_fused_stream_ref(
             x_new, o.packed_vals, o.packed_cols, o.col_starts, o.col_rows,
             o.er_stream(), o.vec_size)),
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
    tables = (o.ell_vals, o.ell_cols, o.col_rows, o.er_stream())
    o64 = p.bind(m, dtype=torch.float64).obj
    with pytest.raises(TypeError):               # fp64 tables
        KM.ehyb_fused_spmm(x.double(), o64.ell_vals, o64.ell_cols,
                           o64.col_rows, o64.er_stream())
    with pytest.raises(TypeError):               # x not in the tables' dtype
        KM.ehyb_fused_spmm(x.bfloat16(), *tables)
    with pytest.raises(ValueError):              # not (n_pad, K)
        KM.ehyb_fused_spmm(x[:-1], *tables)
    with pytest.raises(ValueError):              # ELL-only takes (P, V, K)
        KM.ehyb_ell_spmm(x, o.ell_vals, o.ell_cols, o.col_rows)
    with pytest.raises(TypeError):               # uint16 local columns only
        KM.ehyb_ell_spmm(x.reshape(o.n_parts, o.vec_size, 4), o.ell_vals,
                         o.ell_cols.to(torch.int32), o.col_rows)


def _uniform_matrix(name):
    """``powerlaw_4k`` (ragged widths, ER rows) or its diagonal (ER-free)."""
    m = SUITE["powerlaw_4k"]()
    if name == "powerlaw_4k":
        return m
    rows = np.repeat(np.arange(m.n), m.row_lengths())
    on = rows == m.indices
    return from_coo(m.n, rows[on], m.indices[on], m.data[on])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 16, 17, 32, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["powerlaw_4k", "powerlaw_4k_diagonal"])
def test_uniform_spmm_kernels_match_live_plain(cuda_device, name, dtype, k):
    """#7 and #9 (lane groups, each row read to its width from
    ``col_rows``) against their live-prefix plain versions, on the plan
    sized for K and on the one sized for one column (chunked), and
    bit-identical over two launches."""
    m = _uniform_matrix(name)
    x = torch.as_tensor(np.random.default_rng(k).standard_normal((m.n, k)),
                        device=cuda_device)
    for k_plan in (k, 1):
        op = plan(m, execution=ExecutionConfig(
            format="ehyb", partition_method="bfs", k=k_plan),
            device=cuda_device).bind(m, dtype=dtype)
        assert op.obj.has_er == (name == "powerlaw_4k")
        for kname, wrapper, run, plain in _spmm_cases(op, op.to_space(x)):
            n0 = wrapper.launches
            y, y2 = run(), run()
            assert wrapper.launches == n0 + 2
            y_ref = plain()
            torch.cuda.synchronize()
            assert y.dtype == dtype and y.shape == y_ref.shape
            assert _rel(y, y_ref) <= TOL[dtype], (name, kname, k, k_plan)
            assert torch.equal(y, y2), (name, kname, k, k_plan)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 16])
def test_uniform_kernels_read_only_live_entries(cuda_device, k):
    """A NaN in x_new[0] reaches, through #7 and #9 (#1 and #4 at one
    column), every row whose CSR product reads it and no other row: no
    kernel reads a padded slot (value 0, column 0)."""
    m = SUITE["powerlaw_4k"]()
    op = plan(m, execution=ExecutionConfig(
        format="ehyb", partition_method="bfs", k=k),
        device=cuda_device).bind(m)
    o = op.obj
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (o.n_pad, k)), dtype=torch.float32, device=cuda_device)
    x[0] = float("nan")
    inv = o.inv_perm.cpu().numpy()
    col = int(np.flatnonzero(inv == 0)[0])
    reads = np.zeros(o.n_pad, dtype=bool)
    reads[inv[np.repeat(np.arange(m.n), m.row_lengths())[
        m.indices == col]]] = True
    xp = x.reshape(o.n_parts, o.vec_size, k)
    tiles = (o.ell_vals, o.ell_cols, o.col_rows)
    if k == 1:
        fused = K.ehyb_fused(x[:, 0], *tiles, o.er_stream())[:, None]
        ell = K.ehyb_ell(xp[..., 0], *tiles)[..., None]
    else:
        fused = KM.ehyb_fused_spmm(x, *tiles, o.er_stream())
        ell = KM.ehyb_ell_spmm(xp, *tiles)
    ell_reads = reads.copy()
    ell_reads[o.vec_size:] = False      # x_new[0] is partition 0's
    torch.cuda.synchronize()
    for what, y, want in (("fused", fused, reads),
                          ("ell", ell.reshape(o.n_pad, k), ell_reads)):
        assert want.any() and not want.all()
        nan = torch.isnan(y).cpu().numpy()
        assert nan[want].all(), what
        assert np.isfinite(y.cpu().numpy()[~want]).all(), what


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
        (K.ehyb_ell, lambda: K.ehyb_ell(xp, u.ell_vals, u.ell_cols,
                                        u.col_rows),
         lambda: ref.ehyb_ell_ref(xp[..., None], u.ell_vals,
                                  u.ell_cols, u.col_rows)[..., 0]),
        (K.ehyb_ell_packed, lambda: K.ehyb_ell_packed(xp, *stair),
         lambda: ref.ehyb_ell_packed_ref(xp[..., None], *stair)[..., 0]),
        (K.er, lambda: K.er(x_new, o.er_vals, o.er_cols, o.er_col_rows),
         lambda: ref.er_live_ref(x_new[:, None], o.er_vals, o.er_cols,
                                 o.er_col_rows)[:, 0]),
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
    assert _rel(K.er(xr, o.er_vals, o.er_cols, o.er_col_rows),
                ref.er_ref(xr, o.er_vals, o.er_cols)) <= REL_TOL[dtype]
    if dtype == torch.float32:
        y = K.ehyb_ell_packed(xp, *stair).reshape(-1).clone()
        y.index_add_(0, o.er_row_idx.long(), K.er(x_new, o.er_vals,
                                                  o.er_cols, o.er_col_rows))
        fused = op.apply(x_new, space="permuted")
        assert _rel(y, fused) <= 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", MATS)
def test_er_kernel_reads_the_live_prefixes(cuda_device, name, dtype, r):
    """#6 against its plain version (``ref.er_live_ref``) and the padded
    table's (``ref.er_ref``, finite x) at R rhs columns, rows past the live
    count 0, and two launches bit-identical."""
    m = SUITE[name]()
    o = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                          partition_method="bfs"),
             device=cuda_device).bind(m, dtype=dtype).obj
    x = torch.as_tensor(np.random.default_rng(r).standard_normal(
        (o.n_pad, r)), device=cuda_device).to(dtype)
    n0 = K.er.launches
    y = K.er(x, o.er_vals, o.er_cols, o.er_col_rows)
    assert K.er.launches == n0 + 1
    want = ref.er_live_ref(x, o.er_vals, o.er_cols, o.er_col_rows)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (o.er_vals.shape[0], r)
    assert _rel(y, want) <= REL_TOL[dtype], (name, dtype, r)
    assert _rel(y, ref.er_ref(x, o.er_vals, o.er_cols)) <= REL_TOL[dtype]
    widths = ref.er_widths(o.er_col_rows, o.er_vals.shape[0])
    assert bool((y[widths == 0] == 0).all())
    assert torch.equal(y, K.er(x, o.er_vals, o.er_cols, o.er_col_rows))


@pytest.mark.cuda
def test_er_kernel_rejects_a_width_array_of_the_wrong_shape(cuda_device):
    m = SUITE["powerlaw_4k"]()
    o = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                          partition_method="bfs"),
             device=cuda_device).bind(m).obj
    x = torch.ones(o.n_pad, device=cuda_device)
    for bad in (o.er_col_rows[:-1], o.er_col_rows[None, :],
                torch.zeros(o.er_vals.shape[1] + 1, dtype=torch.int32,
                            device=cuda_device)):
        with pytest.raises(ValueError, match="er_col_rows"):
            K.er(x, o.er_vals, o.er_cols, bad)
    with pytest.raises(TypeError):                 # int32 widths only
        K.er(x, o.er_vals, o.er_cols, o.er_col_rows.long())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SUITE))
def test_fused_spmm_kernels_on_the_stream(cuda_device, name, dtype, k):
    """#7 and #8 against the stream plain versions on every SUITE matrix,
    on plans sized for K and on the k = 1 plan, two launches bit-identical,
    and the same bits at another chunk width (each column's sum keeps its
    order whatever the chunks)."""
    m = SUITE[name]()
    x = torch.as_tensor(np.random.default_rng(k).standard_normal((m.n, k)),
                        device=cuda_device)
    for fmt in ("ehyb", "ehyb_packed"):
        for plan_k in (k, 1):
            op = plan(m, execution=ExecutionConfig(
                format=fmt, partition_method="bfs", k=plan_k),
                device=cuda_device).bind(m, dtype=dtype)
            kname, wrapper, run, plain = _spmm_cases(op, op.to_space(x))[0]
            n0 = wrapper.launches
            y = run()
            assert wrapper.launches == n0 + 1
            y_ref = plain()
            torch.cuda.synchronize()
            assert y.dtype == dtype and y.shape == y_ref.shape
            assert _rel(y, y_ref) <= TOL[dtype], (name, kname, plan_k)
            assert torch.equal(y, run()), (name, kname, plan_k)
            chunked = _spmm_cases(op, op.to_space(x), rhs_chunk=3)[0][2]
            assert torch.equal(y, chunked()), (name, kname, plan_k)


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


# ---------------------------------------------------------------------------
# the value path on the card: refill, device bind, backward
# ---------------------------------------------------------------------------

REFILL_MATS = ["poisson3d_16", "elasticity_8", "powerlaw_4k", "circuit_4k"]
VALUE_FIELDS = ("packed_vals", "ell_vals", "er_vals", "er_p_vals",
                "er_s_vals")


def _new_values(m, seed=7):
    data = np.random.default_rng(seed).standard_normal(m.nnz)
    data[::5] = 0.0                     # stored zeros keep their slots
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
@pytest.mark.parametrize("name", REFILL_MATS)
def test_refill_on_the_card_matches_a_fresh_bind(cuda_device, name, fmt,
                                                 dtype):
    """Every value field of a refilled container bit-identical to a fresh
    bind of the new values (``er_s_vals``, which the fused kernels read,
    included), every other field the same tensor (``data_ptr``), and the
    fused kernel on the refilled container against its plain version."""
    import dataclasses

    from repro_torch.core.matrices import SparseCSR

    m = SUITE[name]()
    m2 = SparseCSR(m.n, m.indptr, m.indices, _new_values(m))
    ex = ExecutionConfig(format=fmt, partition_method="bfs")
    op1 = plan(m, execution=ex, device=cuda_device,
               cache=PlanCache()).bind(m, dtype=dtype)
    before = counters.snapshot()
    op2 = op1.update_values(m2)
    after = counters.snapshot()
    for c in ("partition", "build_ehyb", "pack_staircase", "group_er"):
        assert after.get(c, 0) == before.get(c, 0), c
    fresh = plan(m, execution=ex, device=cuda_device,
                 cache=PlanCache()).bind(m2, dtype=dtype)
    for f in dataclasses.fields(op2.obj):
        a, b = getattr(op2.obj, f.name), getattr(fresh.obj, f.name)
        if not isinstance(a, torch.Tensor):
            assert a == b, f.name
            continue
        assert a.device.type == "cuda" and torch.equal(a, b), f.name
        old = getattr(op1.obj, f.name)
        if f.name in VALUE_FIELDS:
            assert a.data_ptr() != old.data_ptr(), f.name
        else:
            assert a.data_ptr() == old.data_ptr(), f.name
    o = op2.obj
    x_new = op2.to_space(np.random.default_rng(0).standard_normal(m.n))
    y = op2.apply(x_new, space="permuted")
    if fmt == "ehyb_packed":
        y_ref = ref.ehyb_packed_fused_stream_ref(
            x_new[:, None], o.packed_vals, o.packed_cols, o.col_starts,
            o.col_rows, o.er_stream(), o.vec_size, o.has_er)[:, 0]
    else:
        y_ref = ref.ehyb_fused_stream_ref(
            x_new[:, None], o.ell_vals, o.ell_cols, o.col_rows,
            o.er_stream(), o.has_er)[:, 0]
    torch.cuda.synchronize()
    assert _rel(y, y_ref) <= TOL[dtype]
    x = np.random.default_rng(1).standard_normal(m.n)
    got = (op2 @ x).double().cpu().numpy()
    tol = 1e-4 if dtype == torch.float32 else 1e-1
    assert np.abs(got - m2.spmv(x)).max() <= tol * max(
        np.abs(m2.spmv(x)).max(), 1.0)
    assert op2.plan.degraded == {}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["elasticity_8", "powerlaw_4k"])
def test_device_bind_equals_host_bind_on_the_card(cuda_device, name):
    """``plan.bind(tensor)`` scatters on the card into the same tables as
    the host bind of the same values."""
    import dataclasses

    m = SUITE[name]()
    data = _new_values(m, seed=3)
    p = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                          partition_method="bfs"),
             device=cuda_device, cache=PlanCache())
    op1 = p.bind(m)
    opt = p.bind(torch.as_tensor(data, device=cuda_device))
    oph = p.bind(data)
    for f in dataclasses.fields(opt.obj):
        a = getattr(opt.obj, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, getattr(oph.obj, f.name)), f.name
            if f.name not in VALUE_FIELDS:
                assert a.data_ptr() == getattr(op1.obj, f.name).data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("name", ["poisson3d_16", "powerlaw_4k"])
def test_backward_launches_the_kernels(cuda_device, name, k):
    """The backward's Aᵀ ḡ runs on the transpose plan's operator through #2
    (K = 1) or #8 (K ≥ 2), one launch; the gradients agree with the CPU
    port's plain path on the same inputs."""
    m = SUITE[name]()
    rng = np.random.default_rng(k)
    shape = (m.n,) if k == 1 else (m.n, k)
    x, v = rng.standard_normal(shape), rng.standard_normal(shape)
    ex = ExecutionConfig(format="ehyb_packed", partition_method="bfs", k=k)
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = plan(m, execution=ex, device=dev, cache=PlanCache())
        vals = torch.tensor(m.data, dtype=torch.float32, device=dev,
                            requires_grad=True)
        xt = torch.tensor(x, dtype=torch.float32, device=dev,
                          requires_grad=True)
        vt = torch.as_tensor(v, dtype=torch.float32, device=dev)

        def step():
            vals.grad = xt.grad = None
            (p.bind(vals) @ xt * vt).sum().backward()

        step()                          # resolves the transpose's guards
        if dev.type == "cuda":
            kern = K.ehyb_packed_fused if k == 1 else \
                KM.ehyb_packed_fused_spmm
            n0 = kern.launches
            step()
            torch.cuda.synchronize()
            assert kern.launches == n0 + 2      # the forward and Aᵀ ḡ
            assert p.degraded == {} and p.transpose.degraded == {}
            assert (p.transpose is p) == (name == "poisson3d_16")
        grads[dev.type] = (xt.grad.double().cpu(), vals.grad.double().cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _rel(got, want) <= 1e-4


@pytest.mark.cuda
def test_fp64_cotangent_raises_on_the_card(cuda_device):
    """The transpose is bound at the cotangent's fp64 and the kernels take
    no fp64: the backward raises rather than rounding the cotangent."""
    m = SUITE["poisson3d_16"]()
    op = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                           partition_method="bfs"),
              device=cuda_device, cache=PlanCache()).bind(m)
    x = torch.randn(m.n, dtype=torch.float64, device=cuda_device,
                    requires_grad=True)
    y = op @ x
    assert y.dtype == torch.float64
    with pytest.raises(TypeError):
        y.sum().backward()


@pytest.mark.cuda
def test_update_values_rejects_nan_on_the_card(cuda_device):
    m = SUITE["elasticity_8"]()
    op = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                           partition_method="bfs"),
              device=cuda_device, cache=PlanCache()).bind(m)
    bad = m.data.copy()
    bad[-1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        op.update_values(bad)
    with pytest.raises(ValueError, match="non-finite"):
        op.update_values(torch.as_tensor(bad, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("foreach", [False, True])
def test_layer_follows_its_parameter_on_the_card(cuda_device, foreach):
    """One ``torch.optim.SGD`` step on the card (for-loop and foreach
    updates) and a ``load_state_dict``: the next forward launches #8 on
    tables rebound to the stepped parameter, with no structure pass, and
    equals a fresh bind of the same values."""
    from repro_torch.api import pruned_linear
    from repro_torch.core.matrices import SparseCSR
    from repro_torch.core.sparse_linear import SparseLinear

    rng = np.random.default_rng(11)
    w = rng.normal(0.0, 0.02, (256, 1024))
    x = torch.as_tensor(rng.standard_normal((16, 1024)), dtype=torch.float32,
                        device=cuda_device)
    layer = pruned_linear(w, 0.1, format="ehyb_packed",
                          partition_method="bfs", k=16, device=cuda_device)
    opt = torch.optim.SGD(layer.parameters(), lr=0.5, foreach=foreach)
    y0 = layer(x)
    (y0 ** 2).mean().backward()
    opt.step()
    before = counters.snapshot()
    n0 = KM.ehyb_packed_fused_spmm.launches
    with torch.no_grad():
        y1 = layer(x)
    torch.cuda.synchronize()
    assert KM.ehyb_packed_fused_spmm.launches == n0 + 1
    after = counters.snapshot()
    for c in ("partition", "build_ehyb", "pack_staircase", "group_er",
              "ehyb_refill", "kernels.nvcc"):
        assert after.get(c, 0) == before.get(c, 0), c
    c = layer.csr
    m = SparseCSR(c.n, c.indptr, c.indices,
                  layer.values.detach().double().cpu().numpy())
    fresh = SparseLinear(
        d_in=1024, d_out=256, density=0.1, csr=m,
        op=plan(m, execution=layer.op.plan.execution, device=cuda_device,
                cache=PlanCache()).bind(m))
    with torch.no_grad():
        assert torch.equal(y1, fresh(x))
    assert not torch.equal(y1, y0.detach())
    other = pruned_linear(-w, 0.1, format="ehyb_packed",
                          partition_method="bfs", k=16, device=cuda_device)
    other.load_state_dict(layer.state_dict())
    with torch.no_grad():
        assert torch.equal(other(x), y1)
    assert layer.op.plan.degraded == {} and other.op.plan.degraded == {}


# ---------------------------------------------------------------------------
# the default plan on the card: autotuned partition and format, the
# measured pass with CUDA events, the five plain formats
# ---------------------------------------------------------------------------

def _oracle(m, x):
    return m.to_dense() @ x


@pytest.mark.cuda
def test_default_plan_picks_least_bytes_and_launches_its_kernel(
        cuda_device):
    from repro_torch.api.plan import partition_sizing
    from repro_torch.autotune import get_format

    m = SUITE["elasticity_8"]()
    p = plan(m, device=cuda_device, cache=PlanCache())
    table = p.tuning.modeled_bytes
    assert p.format == min(sorted(table), key=table.get)  # all eligible
    assert (p.n_parts, p.vec_size) == partition_sizing(m.n, cuda_device)
    assert p.partition.method == p.partition_tuning.strategy
    op = p.bind(m)
    x = np.random.default_rng(0).standard_normal(m.n)
    n0 = K.ehyb_packed_fused.launches
    y = (op @ torch.as_tensor(x, dtype=torch.float32,
                              device=cuda_device)).cpu()
    assert _rel(y, torch.as_tensor(_oracle(m, x))) <= 1e-4
    if get_format(p.format).kernel == "cuda":
        assert K.ehyb_packed_fused.launches > n0
    b = m.spmv(np.ones(m.n))
    r = op.solve(torch.as_tensor(b, dtype=torch.float32,
                                 device=cuda_device), precond="spai",
                 tol=1e-6)
    assert r.status == "converged"
    assert p.degraded == {}


@pytest.mark.cuda
def test_measured_pass_times_with_cuda_events(cuda_device):
    from repro_torch.autotune import tuner

    m = SUITE["elasticity_8"]()
    before = counters.snapshot().get("tune.measured", 0)
    p = plan(m, execution=ExecutionConfig(mode="measure"),
             device=cuda_device, cache=PlanCache())
    meas = p.tuning.measured_s
    assert meas and all(t > 0 for t in meas.values())
    assert p.format == min(sorted(meas), key=meas.get)
    assert counters.snapshot()["tune.measured"] >= before + len(meas)
    pk = plan(m, execution=ExecutionConfig(mode="measure", k=16),
              device=cuda_device, cache=PlanCache())
    op = pk.bind(m)
    if pk.format == "ehyb_packed":
        assert len(pk.tuning.sweep_s) == 3
        assert op.obj.rhs_chunk == pk.tuned.rhs_chunk
    X = np.random.default_rng(1).standard_normal((m.n, 16))
    Y = (op @ torch.as_tensor(X, dtype=torch.float32,
                              device=cuda_device)).cpu()
    assert _rel(Y, torch.as_tensor(_oracle(m, X))) <= 1e-4
    t = tuner._time_spmv(lambda o, v: v * 2.0, None,
                         torch.ones(8, device=cuda_device), repeats=1)
    assert t > 0


@pytest.mark.cuda
def test_tuner_raises_an_organic_kernel_failure_on_the_card(cuda_device,
                                                            monkeypatch):
    """On a card plan only an injected fault skips a measured candidate;
    an organic build or launch failure is raised, so it never hides behind
    a plain format."""
    import dataclasses

    from repro_torch.autotune import autotune, registry

    def broken(*a, **kw):
        raise OSError("nvcc failed")
    monkeypatch.setitem(registry.FORMATS, "ehyb_packed", dataclasses.replace(
        registry.get_format("ehyb_packed"), build=broken))
    m = SUITE["elasticity_8"]()
    kw = dict(mode="measure", candidates=("ehyb_packed", "csr"),
              use_cache=False, device=cuda_device)
    with pytest.raises(OSError, match="nvcc failed"):
        autotune(m, **kw)
    monkeypatch.undo()
    before = counters.snapshot().get("tune.candidate_failed", 0)
    with chaos(kernel_failure=("tune:ehyb_packed",)) as cfg:
        with pytest.warns(ReliabilityWarning, match="ehyb_packed"):
            r = autotune(m, **kw)
    assert cfg.injected["kernel:tune:ehyb_packed"] == 1
    assert r.format == "csr" and "ehyb_packed" not in r.measured_s
    assert counters.snapshot()["tune.candidate_failed"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["csr", "ell", "hyb", "ehyb_bucketed",
                                 "dense"])
def test_plain_formats_on_the_card(cuda_device, fmt):
    m = SUITE["unstruct_4k"]()
    ex = ExecutionConfig(format=fmt, partition_method="bfs")
    op = plan(m, execution=ex, device=cuda_device,
              cache=PlanCache()).bind(m)
    for k in (1, 16):
        x = np.random.default_rng(k).standard_normal((m.n, k))
        y = (op @ torch.as_tensor(x, dtype=torch.float32,
                                  device=cuda_device)).cpu()
        assert _rel(y, torch.as_tensor(_oracle(m, x))) <= 1e-4
    m2 = type(m)(m.n, m.indptr, m.indices, 2.0 * m.data)
    op2 = op.update_values(m2)
    fresh = plan(m, execution=ex, device=cuda_device,
                 cache=PlanCache()).bind(m2)
    for a, b in zip(op2.obj.value_tables(), fresh.obj.value_tables()):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert op.plan.degraded == {}

"""Card-only tests of the port's kernels: each kernel against its plain
version on the same CUDA tensors.

Every test here carries the ``cuda`` marker and skips without a Hopper card
(the decision is taken inside the ``cuda_device`` fixture, never at import).
The file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.api import ExecutionConfig, plan
from repro_torch.core.matrices import SUITE
from repro_torch.kernels import ehyb_spmv as K
from repro_torch.kernels import ref
from repro_torch.kernels.solver_step import fused_cg_update

# max|Δ| / max(max|y_ref|, 1), kernel against its plain version on the same
# tables: fp32 at the reference's conformance tolerance
# (tests/test_spmv_conformance.py); in bf16 both accumulate in fp32, so they
# may differ only by the rounding of y, a few bf16 ulps (2^-8) of max|y|
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
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
            n0 = K.ehyb_packed_fused.launches
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
    with pytest.raises(NotImplementedError):
        op @ torch.ones((m.n, 2), device=cuda_device)
    op64 = op.plan.bind(m, dtype=torch.float64)
    with pytest.raises(TypeError):
        op64 @ torch.ones(m.n, device=cuda_device)


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

"""The generators' sizes, the Q1 element and the assembled matrices."""

import itertools

import numpy as np
import pytest

from ehyb_bench.matrices import hpcg27, q1_elasticity


def dense(m):
    a = np.zeros((m.n, m.n))
    for r in range(m.n):
        lo, hi = m.indptr[r], m.indptr[r + 1]
        a[r, m.indices[lo:hi]] = m.data[lo:hi]
    return a


@pytest.mark.parametrize("N", [2, 3, 5])
def test_hpcg_sizes_and_values(N):
    m = hpcg27.generate({"nx": N, "ny": N, "nz": N}, "cpu")
    assert m.n == N ** 3 and m.nnz == (3 * N - 2) ** 3
    a = dense(m)
    assert np.all(np.diag(a) == 26.0)
    off = a - np.diag(np.diag(a))
    assert set(np.unique(off)) <= {0.0, -1.0}
    assert np.array_equal(a, a.T)
    for r in range(m.n):
        row = m.indices[m.indptr[r]:m.indptr[r + 1]]
        assert np.all(np.diff(row) > 0)


def test_hpcg_rows_follow_hpcg_numbering():
    """Row (iz·ny + iy)·nx + ix on a grid whose sides differ."""
    nx, ny, nz = 4, 3, 2
    m = hpcg27.generate({"nx": nx, "ny": ny, "nz": nz}, "cpu")
    a = dense(m)
    for ix, iy, iz in itertools.product(range(nx), range(ny), range(nz)):
        r = (iz * ny + iy) * nx + ix
        want = sum(1 for dx, dy, dz in itertools.product((-1, 0, 1), repeat=3)
                   if 0 <= ix + dx < nx and 0 <= iy + dy < ny
                   and 0 <= iz + dz < nz)
        assert np.count_nonzero(a[r]) == want


@pytest.mark.parametrize("N", [2, 3, 5])
def test_q1_sizes_pattern_and_dirichlet(N):
    m = q1_elasticity.generate({"ne": N - 1, "E": 1.0, "nu": 0.25}, "cpu")
    assert m.n == 3 * N ** 3 and m.nnz == 9 * (3 * N - 2) ** 3
    a = dense(m)
    assert np.abs(a - a.T).max() < 1e-15
    node = np.arange(m.n) // 3
    fixed = (node // N) % N == 0
    for r in np.flatnonzero(fixed):
        assert a[r, r] == 1.0 and np.count_nonzero(a[r]) == 1
        assert np.count_nonzero(a[:, r]) == 1
    assert np.linalg.eigvalsh(a).min() > 0          # SPD with the BCs


def test_q1_pattern_is_the_ports_elasticity3d():
    from repro_torch.core.matrices import elasticity3d

    m = q1_elasticity.generate({"ne": 3, "E": 1.0, "nu": 0.25}, "cpu")
    e = elasticity3d(4)
    assert np.array_equal(m.indptr, e.indptr)
    assert np.array_equal(m.indices, e.indices)


def test_q1_element_symmetric_with_rigid_body_null_space():
    h = 0.25
    k = q1_elasticity.element_stiffness(1.0, 0.25, h)
    assert np.abs(k - k.T).max() < 1e-15
    x = h * q1_elasticity.CORNERS.astype(float)
    modes = []
    for c in range(3):
        u = np.zeros(24)
        u[c::3] = 1.0
        modes.append(u)
    for w in np.eye(3):
        modes.append(np.cross(w, x).reshape(-1))
    modes = np.array(modes)
    assert np.linalg.matrix_rank(modes) == 6
    assert np.abs(k @ modes.T).max() < 1e-12 * np.abs(k).max()
    assert np.linalg.matrix_rank(k) == 18
    assert np.linalg.eigvalsh(k).min() > -1e-12


def test_q1_element_scales_with_h_and_E():
    k1 = q1_elasticity.element_stiffness(1.0, 0.25, 1.0)
    k2 = q1_elasticity.element_stiffness(3.0, 0.25, 0.5)
    assert np.allclose(k2, 1.5 * k1)

"""3-D linear elasticity on trilinear (Q1) hexahedra over the unit cube, as
PETSc's ``src/ksp/ksp/tutorials/ex56.c`` sets it up: ``ne`` elements a
side, ``(ne+1)³`` nodes with 3 displacement dofs each (dof ``3·node + c``,
node ``(z·N + y)·N + x``), Young's modulus E, Poisson ratio ν, and the
dofs of the y = 0 face held by Dirichlet conditions.

The 24 × 24 element matrix is integrated once (2 × 2 × 2 Gauss points) and
added into every element's rows.  The Dirichlet dofs keep their pattern:
their rows and columns are stored zeros with 1 on the diagonal, as
``MatZeroRowsColumns`` leaves them.  The pattern is the 27-point node
stencil with dense 3 × 3 blocks, 9·(3N - 2)³ entries."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ehyb_bench.matrices.grid import Matrix, grid_coords, stencil_pattern

# local node l of an element sits at corner (i, j, k), l = i + 2j + 4k
CORNERS = np.array([(i, j, k) for k in (0, 1) for j in (0, 1)
                    for i in (0, 1)])


def elasticity_matrix(E: float, nu: float) -> np.ndarray:
    """The isotropic 6 × 6 constitutive matrix, Voigt order xx, yy, zz,
    xy, yz, xz (engineering shear strains)."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] += 2 * mu
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    return D


def element_stiffness(E: float, nu: float, h: float) -> np.ndarray:
    """The 24 × 24 stiffness of a cube of side h, dof ``3l + c``."""
    D = elasticity_matrix(E, nu)
    sign = 2.0 * CORNERS - 1.0                      # (8, 3)
    g = 1.0 / np.sqrt(3.0)
    K = np.zeros((24, 24))
    for xi in itertools.product((-g, g), repeat=3):
        f = 1.0 + sign * np.asarray(xi)             # (8, 3) factors
        dN = np.empty((8, 3))                       # dN_l / dx_d
        for d in range(3):
            others = [e for e in range(3) if e != d]
            dN[:, d] = sign[:, d] * f[:, others[0]] * f[:, others[1]] / 8.0
        dN *= 2.0 / h
        B = np.zeros((6, 24))
        for l in range(8):
            dx, dy, dz = dN[l]
            c = 3 * l
            B[0, c], B[1, c + 1], B[2, c + 2] = dx, dy, dz
            B[3, c], B[3, c + 1] = dy, dx
            B[4, c + 1], B[4, c + 2] = dz, dy
            B[5, c], B[5, c + 2] = dz, dx
        K += B.T @ D @ B * (h / 2.0) ** 3
    return K


def generate(params: dict, device) -> Matrix:
    ne = int(params["ne"])
    N = ne + 1
    Ke = torch.as_tensor(element_stiffness(float(params["E"]),
                                           float(params["nu"]), 1.0 / ne),
                         dtype=torch.float64, device=device)
    nb, valid = stencil_pattern((N, N, N), device)
    n_nodes = nb.shape[0]
    deg = valid.sum(1)
    # dof rows 3·node + a, each 3 · deg entries: (node, a, slot, b) order
    lengths = (3 * deg).repeat_interleave(3)
    indptr = torch.zeros(3 * n_nodes + 1, dtype=torch.int64, device=device)
    indptr[1:] = lengths.cumsum(0)
    b3 = torch.arange(3, device=device)
    cols = 3 * nb[:, None, :, None] + b3[None, None, None, :]
    mask = valid[:, None, :, None].expand(n_nodes, 3, 27, 3)
    indices = cols.expand(n_nodes, 3, 27, 3)[mask]
    del cols, mask
    rank = valid.cumsum(1) - 1            # place of a slot among the valid
    data = torch.zeros(indices.numel(), dtype=torch.float64, device=device)
    e = torch.arange(ne ** 3, device=device)
    base = (e % ne) + N * ((e // ne) % ne) + N * N * (e // (ne * ne))
    corner_off = [int(i + N * j + N * N * k) for i, j, k in CORNERS]
    for p, q in itertools.product(range(8), repeat=2):
        dx, dy, dz = (CORNERS[q] - CORNERS[p]).tolist()
        slot = 9 * (dz + 1) + 3 * (dy + 1) + (dx + 1)
        node_p = base + corner_off[p]
        row0 = indptr[3 * node_p[:, None] + b3[None, :]]          # (E, 3)
        pos = (row0[:, :, None] + 3 * rank[node_p, slot][:, None, None]
               + b3[None, None, :])
        blk = Ke[3 * p: 3 * p + 3, 3 * q: 3 * q + 3]
        data.index_add_(0, pos.reshape(-1),
                        blk.expand(pos.shape[0], 3, 3).reshape(-1))
    _, y, _ = grid_coords((N, N, N), device)
    fixed = (y == 0).repeat_interleave(3)          # Dirichlet dofs
    rows = torch.arange(3 * n_nodes, device=device).repeat_interleave(
        lengths)
    data[fixed[rows] | fixed[indices]] = 0.0
    data[(rows == indices) & fixed[rows]] = 1.0
    return Matrix.from_tensors(indptr, indices, data)

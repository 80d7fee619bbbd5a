"""Synthetic sparse-matrix suite mirroring the paper's evaluation set.

A numpy copy of ``repro.core.matrices``: the same generators give the same
matrices from the same seeds.

The paper (Table 3) evaluates on 94 SuiteSparse matrices derived from FEM on
structural / CFD / electromagnetics / biomedical problems — mostly
unstructured-mesh discretizations of 3D PDEs.  The container is offline, so we
generate matrices with the same structural character:

* ``poisson3d``      — 7-point stencil on an n×n×n grid (atmosmodj/l/m-like,
                       structured, narrow band).
* ``poisson3d27``    — 27-point stencil (higher-order FEM, denser rows).
* ``elasticity3d``   — 3 dofs/node vector problem, 27-point node stencil with
                       dense 3×3 blocks (audikw_1 / Emilia-like).
* ``unstructured``   — random geometric graph in a unit cube (Delaunay-ish
                       irregular FEM mesh: variable row degree, spatial
                       locality that a graph partitioner can exploit).
* ``powerlaw``       — heavy-tailed degree distribution (circuit-simulation
                       style: memchip/Freescale1-like imbalance; stresses the
                       ER path and load balancing).
* ``rmat``           — R-MAT / stochastic-Kronecker web/social graph: heavy
                       tails on both axes plus a dense hub core (the target
                       of the ``hub`` partition strategy).
* ``circuit``        — series chains + short couplings + a few near-global
                       rail nets (power/ground/clock columns with huge
                       fan-in), the classic circuit-matrix shape.

All generators return CSR (`SparseCSR`) with float64 values; SpMV paths cast
as requested.  Everything is numpy — this is host-side preprocessing, exactly
as in the paper (METIS + reordering run on the CPU there too).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np


@dataclasses.dataclass
class SparseCSR:
    """Minimal CSR container used by the preprocessing pipeline."""

    n: int
    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray     # (nnz,) float

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.n), dtype=self.data.dtype)
        for r in range(self.n):
            lo, hi = self.indptr[r], self.indptr[r + 1]
            out[r, self.indices[lo:hi]] += self.data[lo:hi]
        return out

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Reference numpy SpMV (row loop-free)."""
        rows = np.repeat(np.arange(self.n), self.row_lengths())
        out = np.zeros(self.n, dtype=np.result_type(self.data, x))
        np.add.at(out, rows, self.data * x[self.indices])
        return out


def symmetrize(m: SparseCSR) -> SparseCSR:
    """(A + Aᵀ)/2 — FEM stiffness matrices are symmetric; generators add
    noise per-entry, so solver-facing matrices are symmetrized (CG needs
    SPD)."""
    rows = np.repeat(np.arange(m.n), m.row_lengths())
    cols = m.indices.astype(np.int64)
    return from_coo(m.n,
                    np.concatenate([rows, cols]),
                    np.concatenate([cols, rows]).astype(np.int32),
                    np.concatenate([m.data, m.data]) * 0.5)


def from_coo(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
             sum_duplicates: bool = True) -> SparseCSR:
    """COO → CSR with optional duplicate summation (deterministic order)."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and len(rows) > 0:
        key = rows.astype(np.int64) * n + cols.astype(np.int64)
        uniq, inv = np.unique(key, return_inverse=True)
        vsum = np.zeros(len(uniq), dtype=vals.dtype)
        np.add.at(vsum, inv, vals)
        rows = (uniq // n).astype(np.int64)
        cols = (uniq % n).astype(np.int32)
        vals = vsum
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return SparseCSR(n=n, indptr=indptr, indices=cols.astype(np.int32),
                     data=vals.astype(np.float64))


def _stencil_matrix(nx: int, ny: int, nz: int, offsets, seed: int) -> SparseCSR:
    """Build a stencil matrix on an nx×ny×nz grid with SPD-ish diagonal."""
    rng = np.random.default_rng(seed)
    n = nx * ny * nz
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    rows_all, cols_all, vals_all = [], [], []
    for (dx, dy, dz) in offsets:
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
              & (jz >= 0) & (jz < nz))
        r = (ix[ok] * ny + iy[ok]) * nz + iz[ok]
        c = (jx[ok] * ny + jy[ok]) * nz + jz[ok]
        if dx == dy == dz == 0:
            v = np.full(len(r), float(len(offsets)) + 1.0)
        else:
            v = -1.0 + 0.05 * rng.standard_normal(len(r))
        rows_all.append(r)
        cols_all.append(c)
        vals_all.append(v)
    return from_coo(n, np.concatenate(rows_all), np.concatenate(cols_all),
                    np.concatenate(vals_all), sum_duplicates=False)


def poisson3d(nx: int = 16, ny: int | None = None, nz: int | None = None,
              seed: int = 0) -> SparseCSR:
    ny = ny or nx
    nz = nz or nx
    offsets = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
               (0, 0, 1), (0, 0, -1)]
    return _stencil_matrix(nx, ny, nz, offsets, seed)


def poisson3d27(nx: int = 12, seed: int = 1) -> SparseCSR:
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]
    return _stencil_matrix(nx, nx, nx, offsets, seed)


def elasticity3d(nx: int = 8, seed: int = 2) -> SparseCSR:
    """3 dofs per node, 27-point node stencil, dense 3×3 coupling blocks.
    Symmetrized (stiffness matrices are SPD-structured)."""
    rng = np.random.default_rng(seed)
    node = poisson3d27(nx, seed=seed)
    n = node.n * 3
    rows, cols, vals = [], [], []
    node_rows = np.repeat(np.arange(node.n), node.row_lengths())
    for a in range(3):
        for b in range(3):
            rows.append(node_rows * 3 + a)
            cols.append(node.indices.astype(np.int64) * 3 + b)
            # diagonal dominance: ~81 neighbour blocks × |-1| per row needs
            # diag > 81·3 within the 3×3 block rows for SPD
            base = np.where(node_rows == node.indices, 260.0 * (a == b), -1.0)
            vals.append(base + 0.05 * rng.standard_normal(node.nnz))
    return symmetrize(from_coo(n, np.concatenate(rows),
                               np.concatenate(cols), np.concatenate(vals),
                               sum_duplicates=False))


def unstructured(n: int = 4096, avg_degree: int = 14, seed: int = 3) -> SparseCSR:
    """Random geometric graph in the unit cube — irregular FEM-mesh stand-in.

    Spatially local (partitioner-friendly) but with variable row degree, like
    an unstructured tetrahedral mesh.  Built via a uniform grid bucketing so
    generation is O(n · k).
    """
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    # choose radius so expected neighbour count ≈ avg_degree
    radius = (avg_degree / (n * 4.0 / 3.0 * np.pi)) ** (1.0 / 3.0)
    nbins = max(1, int(1.0 / radius))
    bin_idx = np.minimum((pts * nbins).astype(np.int64), nbins - 1)
    flat = (bin_idx[:, 0] * nbins + bin_idx[:, 1]) * nbins + bin_idx[:, 2]
    order = np.argsort(flat, kind="stable")
    buckets: Dict[int, np.ndarray] = {}
    start = 0
    sorted_flat = flat[order]
    boundaries = np.flatnonzero(np.diff(sorted_flat)) + 1
    for seg in np.split(order, boundaries):
        if len(seg):
            buckets[int(flat[seg[0]])] = seg
        start += len(seg)
    rows, cols = [], []
    r2 = radius * radius
    for b, members in buckets.items():
        bz = b % nbins
        by = (b // nbins) % nbins
        bx = b // (nbins * nbins)
        neigh = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    nx_, ny_, nz_ = bx + dx, by + dy, bz + dz
                    if 0 <= nx_ < nbins and 0 <= ny_ < nbins and 0 <= nz_ < nbins:
                        key = (nx_ * nbins + ny_) * nbins + nz_
                        if key in buckets:
                            neigh.append(buckets[key])
        cand = np.concatenate(neigh)
        d2 = ((pts[members][:, None, :] - pts[cand][None, :, :]) ** 2).sum(-1)
        mi, ci = np.nonzero(d2 < r2)
        rows.append(members[mi])
        cols.append(cand[ci])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.where(rows == cols, 2.0 * avg_degree,
                    -1.0 + 0.05 * rng.standard_normal(len(rows)))
    return from_coo(n, rows, cols, vals, sum_duplicates=True)


def powerlaw(n: int = 4096, avg_degree: int = 8, alpha: float = 2.1,
             seed: int = 4) -> SparseCSR:
    """Heavy-tailed row degrees (circuit-style imbalance)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(
        (rng.pareto(alpha - 1.0, n) + 1.0) * (avg_degree / 2.0), n / 4
    ).astype(np.int64)
    deg = np.maximum(deg, 1)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.shape[0])
    # ensure non-empty diagonal for solvability
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.where(rows == cols, 4.0 * avg_degree,
                    -1.0 + 0.05 * rng.standard_normal(len(rows)))
    return from_coo(n, rows, cols, vals, sum_duplicates=True)


def rmat(n: int = 4096, avg_degree: int = 8, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, seed: int = 5) -> SparseCSR:
    """R-MAT / stochastic-Kronecker web/social graph (Chakrabarti et al.).

    Each edge picks a quadrant per bit level with probabilities (a, b, c, d);
    the skew (default a=0.57) yields heavy-tailed degrees on BOTH axes, a
    dense hub↔hub core, and self-similar block structure — the pattern
    family degree-sorted hub extraction targets.  Bit sampling is fully
    vectorized: one (nnz, scale) uniform draw, one searchsorted.  ``n`` that
    is not a power of two is generated in the enclosing 2^⌈log2 n⌉ space and
    folded back with a modulo.  Symmetrized with a dominant diagonal so the
    matrix also serves the solver paths.
    """
    rng = np.random.default_rng(seed)
    scale = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    nnz = n * avg_degree
    probs = np.array([a, b, c, max(1.0 - (a + b + c), 0.0)])
    edges = np.searchsorted(np.cumsum(probs / probs.sum()),
                            rng.random((nnz, scale)))
    weights = (1 << np.arange(scale - 1, -1, -1)).astype(np.int64)
    er = ((edges >> 1) @ weights) % n
    ec = ((edges & 1) @ weights) % n
    rows = np.concatenate([er, ec, np.arange(n)])
    cols = np.concatenate([ec, er, np.arange(n)])
    vals = np.where(rows == cols, 4.0 * avg_degree,
                    -1.0 + 0.05 * rng.standard_normal(len(rows)))
    return from_coo(n, rows, cols.astype(np.int32), vals)


def circuit(n: int = 4096, rail_count: int = 4, avg_local: int = 6,
            seed: int = 6) -> SparseCSR:
    """Circuit-simulation pattern: local couplings + near-global rail nets.

    A series chain plus short-range random couplings form the locally banded
    core (almost every row is tiny and spatially local); every node also
    hangs off one of ``rail_count`` power/ground/clock rails — columns with
    in-degree ≈ n/rail_count, the memchip/Freescale-style dense columns that
    wreck contiguous partitionings and reward routing the rails' vertices to
    a shared hub partition.  Symmetrized with a dominant diagonal.
    """
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    src = rng.integers(0, n, n * max(avg_local - 2, 1) // 2)
    dst = np.clip(src + rng.geometric(0.15, len(src)), 0, n - 1)
    rail = rng.integers(0, rail_count, n)
    rows = np.concatenate([i[1:], i[:-1], src, dst, i, rail, i])
    cols = np.concatenate([i[:-1], i[1:], dst, src, rail, i, i])
    vals = np.where(rows == cols, 4.0 * (avg_local + 4),
                    -1.0 + 0.05 * rng.standard_normal(len(rows)))
    return from_coo(n, rows, cols.astype(np.int32), vals)


# The benchmark suite: name → constructor, scaled to CPU-tractable sizes but
# structurally matched to the paper's categories (Table 3).
SUITE: Dict[str, Callable[[], SparseCSR]] = {
    # CFD / structured (atmosmod*-like)
    "poisson3d_16": lambda: poisson3d(16),
    "poisson3d_24": lambda: poisson3d(24),
    # higher-order FEM (consph/cant-like density)
    "poisson27_12": lambda: poisson3d27(12),
    "poisson27_16": lambda: poisson3d27(16),
    # structural vector FEM (audikw_1-like 3×3 blocks)
    "elasticity_8": lambda: elasticity3d(8),
    "elasticity_10": lambda: elasticity3d(10),
    # unstructured meshes (irregular degree, spatially local)
    "unstruct_4k": lambda: unstructured(4096, 14),
    "unstruct_8k": lambda: unstructured(8192, 18),
    # circuit style (stress ER/balance — the hard case for EHYB)
    "powerlaw_4k": lambda: powerlaw(4096, 8),
    "powerlaw_8k": lambda: powerlaw(8192, 6),
    # web/social graph (R-MAT Kronecker: hub core + self-similar blocks)
    "rmat_4k": lambda: rmat(4096, 8),
    "rmat_8k": lambda: rmat(8192, 6),
    # circuit pattern proper (near-global rail nets over a banded core)
    "circuit_4k": lambda: circuit(4096),
}

"""What the generators share: the host matrix they hand out, and the
27-point neighbourhood of every point of a structured grid."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Matrix:
    """A square CSR matrix on the host: ``indptr`` (n+1,) int64, ``indices``
    (nnz,) int32 ascending within a row, ``data`` (nnz,) float64."""

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @classmethod
    def from_tensors(cls, indptr: torch.Tensor, indices: torch.Tensor,
                     data: torch.Tensor) -> "Matrix":
        return cls(n=indptr.numel() - 1,
                   indptr=indptr.to(torch.int64).cpu().numpy(),
                   indices=indices.to(torch.int32).cpu().numpy(),
                   data=data.to(torch.float64).cpu().numpy())


def grid_coords(dims: tuple, device):
    """x, y, z of every point of an ``nx × ny × nz`` grid, numbered
    ``(z·ny + y)·nx + x``."""
    nx, ny, nz = dims
    p = torch.arange(nx * ny * nz, device=device)
    return p % nx, (p // nx) % ny, p // (nx * ny)


def stencil_pattern(dims: tuple, device):
    """(points, 27) neighbour numbers and their validity.  Slot
    ``9(dz+1) + 3(dy+1) + (dx+1)`` holds the neighbour at offset (dx, dy,
    dz); along a row the valid slots are in ascending neighbour order."""
    nx, ny, nz = dims
    x, y, z = grid_coords(dims, device)
    d = torch.tensor([-1, 0, 1], device=device)
    dz, dy, dx = torch.meshgrid(d, d, d, indexing="ij")
    dx, dy, dz = dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)
    nb = (x[:, None] + dx) + nx * ((y[:, None] + dy) + ny * (z[:, None] + dz))
    valid = ((x[:, None] + dx >= 0) & (x[:, None] + dx < nx)
             & (y[:, None] + dy >= 0) & (y[:, None] + dy < ny)
             & (z[:, None] + dz >= 0) & (z[:, None] + dz < nz))
    return nb, valid

"""HPCG's reference problem (``src/GenerateProblem_ref.cpp``): a 27-point
stencil on an ``nx × ny × nz`` grid, 26 on the diagonal and -1 for every
neighbour inside the grid.  Row ``(iz·ny + iy)·nx + ix``, columns ascending,
as HPCG numbers them.  Made with torch on ``device`` and returned on the
host."""

from __future__ import annotations

import torch

from ehyb_bench.matrices.grid import Matrix, stencil_pattern


def generate(params: dict, device) -> Matrix:
    dims = (int(params["nx"]), int(params["ny"]), int(params["nz"]))
    nb, valid = stencil_pattern(dims, device)
    indices = nb[valid]
    centre = torch.zeros(27, dtype=torch.bool, device=device)
    centre[13] = True
    data = torch.where(centre.expand_as(valid)[valid],
                       float(params.get("diagonal", 26.0)),
                       float(params.get("off_diagonal", -1.0))).double()
    indptr = torch.zeros(nb.shape[0] + 1, dtype=torch.int64, device=device)
    indptr[1:] = valid.sum(1).cumsum(0)
    return Matrix.from_tensors(indptr, indices, data)

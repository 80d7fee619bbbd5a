"""The plain reference product: a CSR matrix's rows padded to the widest
row, ``y_i = Σ_j a_ij x_j`` as a gather and a sum in row blocks, in plain
PyTorch.  It reads the benchmark's host matrix only, and imports nothing
of the program."""

from __future__ import annotations

import numpy as np
import torch

# elements of a gathered (rows, W, K) block
_BLOCK_ELEMS = 1 << 25


class PaddedRows:
    """``matrix`` (``n``, ``indptr``, ``indices``, ``data`` on the host) as
    (n, W) columns and values on ``device``; padding slots hold column 0
    and the value 0.  Values are kept at ``dtype``."""

    def __init__(self, matrix, device, dtype=torch.float64):
        indptr = torch.as_tensor(np.asarray(matrix.indptr, np.int64),
                                 device=device)
        lengths = indptr[1:] - indptr[:-1]
        self.n = int(matrix.n)
        self.width = int(lengths.max()) if self.n else 0
        rows = torch.arange(self.n, device=device).repeat_interleave(lengths)
        slot = torch.arange(rows.numel(), device=device) - indptr[rows]
        self.cols = torch.zeros((self.n, self.width), dtype=torch.int64,
                                device=device)
        self.vals = torch.zeros((self.n, self.width), dtype=dtype,
                                device=device)
        self.cols[rows, slot] = torch.as_tensor(
            np.asarray(matrix.indices, np.int64), device=device)
        self.vals[rows, slot] = torch.as_tensor(
            np.asarray(matrix.data, np.float64), device=device).to(dtype)

    def matmul(self, x: torch.Tensor, acc=torch.float64) -> torch.Tensor:
        """A x for x of shape (n,) or (n, K), summed in ``acc``; the inputs
        are taken at their own dtypes before they are widened."""
        x2 = x.reshape(self.n, -1)
        k = x2.shape[1]
        y = torch.empty((self.n, k), dtype=acc, device=x.device)
        step = max(1, _BLOCK_ELEMS // max(self.width * k, 1))
        for r0 in range(0, self.n, step):
            r1 = min(r0 + step, self.n)
            xs = x2[self.cols[r0:r1]].to(acc)             # (rows, W, K)
            y[r0:r1] = (self.vals[r0:r1, :, None].to(acc) * xs).sum(1)
        return y.reshape(x.shape)

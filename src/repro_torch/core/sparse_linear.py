"""SparseLinear — a pruned weight matrix as a layer, through the batched
apply.

The port of ``repro.core.sparse_linear``.  A magnitude-pruned weight matrix
is planned and bound in an EHYB format and applied with the batched (SpMM)
path: the *columns* of W (= input features) are partitioned, and each
partition's slice of the activations plays the role of the paper's cached
input vector.  A forward over T tokens is one apply of T right-hand sides.

The formats are square (row and column vertices share the partition), so a
rectangular weight is embedded in a max(d_in, d_out) square with empty
padding rows — the padding holds no entries and its x-slices are never
read.

:class:`SparseLinear` is an ``nn.Module`` whose ``forward`` is the
reference's ``__call__``.  It holds no parameters: the weights live in the
operator's device tables (value training through a VJP and the refill of
``update_values`` are later slices).  ``EHYBLinear`` is the layer pinned to
the uniform EHYB format.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..autotune.registry import get_format
from .ehyb import EHYB
from .matrices import SparseCSR, from_coo


def _host_ehyb_of(op) -> EHYB:
    """The host EHYB build behind a bound operator (memoized in its plan's
    cache, so asking again builds nothing)."""
    return op.plan.host_build(op.csr)


def prune_to_csr(w: np.ndarray, density: float) -> SparseCSR:
    """Magnitude-prune a dense (d_out, d_in) matrix into a square-padded CSR."""
    d_out, d_in = w.shape
    n = max(d_out, d_in)
    k = max(1, int(w.size * density))
    thresh = np.partition(np.abs(w).ravel(), -k)[-k]
    rows, cols = np.nonzero(np.abs(w) >= thresh)
    return from_coo(n, rows.astype(np.int64), cols.astype(np.int32),
                    w[rows, cols].astype(np.float64), sum_duplicates=False)


class SparseLinear(nn.Module):
    """y = W_pruned x over the last axis of x, W bound as ``op``."""

    def __init__(self, d_in: int, d_out: int, op, density: float,
                 csr: Optional[SparseCSR] = None,
                 ehyb: Optional[EHYB] = None):
        super().__init__()
        self.d_in = d_in
        self.d_out = d_out
        self.op = op
        self.density = density
        self.csr = csr          # host pattern (bytes accounting)
        self.ehyb = ehyb        # host EHYB build of the bound values

    def extra_repr(self) -> str:
        return (f"d_in={self.d_in}, d_out={self.d_out}, "
                f"density={self.density}, format={self.op.format!r}")

    def update_values(self, w: np.ndarray) -> "SparseLinear":
        raise NotImplementedError(
            "update_values refills the operator's value tables on the fixed "
            "pruning mask; the refill path (EHYB.refill, "
            "LinearOperator.update_values) is not ported yet (ROADMAP "
            "Queue 1 item 1)")

    # ---- permuted-space threading -----------------------------------------
    # A single application permutes activations in and outputs out anyway,
    # so ``forward`` rides the operator's original-space apply.  Stacked
    # layers sharing one partitioning, or callers that keep activations
    # resident between applies, hoist the gathers with the space API below.

    @property
    def supports_permuted(self) -> bool:
        return self.op.supports_permuted

    def to_permuted(self, x) -> torch.Tensor:
        """(..., d_in) activations -> (..., n_pad) permuted padded space."""
        x = self.op._promote(x)
        lead = x.shape[:-1]
        xt = self._embed(x.reshape(-1, self.d_in).T)
        return self.op.to_space(xt).T.reshape(*lead, self.op.n_pad)

    def from_permuted(self, y_new) -> torch.Tensor:
        """(..., n_pad) permuted outputs -> (..., d_out)."""
        y_new = torch.as_tensor(y_new, device=self.op.device)
        lead = y_new.shape[:-1]
        yt = self.op.from_space(y_new.reshape(-1, self.op.n_pad).T)
        return yt[: self.d_out].T.reshape(*lead, self.d_out)

    def _embed(self, xt: torch.Tensor) -> torch.Tensor:
        n = self.op.n
        if n > self.d_in:
            xt = torch.cat([xt, xt.new_zeros((n - self.d_in, xt.shape[1]))])
        return xt

    def forward(self, x, space: str = "original") -> torch.Tensor:
        """x: (..., d_in) -> (..., d_out) through the batched apply.

        ``space="permuted"`` treats x as (..., n_pad) permuted activations
        and returns (..., n_pad) permuted outputs (no gathers — for chained
        applications between ``to_permuted``/``from_permuted``)."""
        return self.apply_with(self.op.obj, x, space)

    def apply_with(self, obj, x, space: str = "original") -> torch.Tensor:
        """``forward`` with an explicit device container ``obj`` of the
        operator's format (the same structure, other values)."""
        spec = get_format(self.op.format)
        x = self.op._promote(x)
        lead = x.shape[:-1]
        if space == "permuted":
            xt = x.reshape(-1, self.op.n_pad).T
            return spec.permuted(obj, xt).T.reshape(*lead, self.op.n_pad)
        xt = self._embed(x.reshape(-1, self.d_in).T)     # (n, T)
        yt = spec.apply(obj, xt)                         # (n, T)
        return yt[: self.d_out].T.reshape(*lead, self.d_out)

    def bytes_vs_dense(self, val_bytes: int = 4) -> dict:
        """Modeled bytes of one original-space apply (boundary permutes
        paid, ER fused) against the dense weight's."""
        dense = self.d_in * self.d_out * val_bytes
        sparse = self.ehyb.bytes_moved(val_bytes, space="original",
                                       fused_er=True)["total"]
        return {"dense": dense, "format": self.op.format,
                "sparse": sparse, "ehyb": sparse, "ratio": sparse / dense}


class EHYBLinear(SparseLinear):
    """The paper's layer: SparseLinear pinned to the EHYB format."""

    @classmethod
    def from_dense(cls, w: np.ndarray, density: float = 0.1,
                   method: str = "bfs", dtype=torch.float32,
                   device=None) -> "EHYBLinear":
        from ..api.nn import pruned_linear

        return pruned_linear(w, density, format="ehyb", dtype=dtype,
                             partition_method=method, cls=cls, device=device)

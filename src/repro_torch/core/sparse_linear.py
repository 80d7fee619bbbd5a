"""SparseLinear — a pruned weight matrix as a layer, through the batched
apply.

The port of ``repro.core.sparse_linear``.  A magnitude-pruned weight matrix
is planned and bound (in the autotuned format by default) and applied
with the batched (SpMM) path.  In an EHYB format the *columns* of W (=
input features) are partitioned, and each partition's slice of the
activations plays the role of the paper's cached input vector.  A forward
over T tokens is one apply of T right-hand sides.

The formats are square (row and column vertices share the partition), so a
rectangular weight is embedded in a max(d_in, d_out) square with empty
padding rows — the padding holds no entries and its x-slices are never
read.

:class:`SparseLinear` is an ``nn.Module`` whose ``forward`` is the
reference's ``__call__``.  Its one parameter, ``values``, holds the
weights (one per kept entry, in the CSR order of the square pattern), and
it decides the output: the apply reads the operator's device tables, and
a forward first rebinds the operator whenever the parameter changed since
it was bound — an optimizer step, ``load_state_dict``, an in-place edit or
a new ``Parameter`` — by a scatter of the values into new tables on the
device (``plan.bind`` of a tensor: no partitioning, no build, no packing,
no host work).  An edit through ``values.data`` bypasses the version
counter that this reads and is not seen.  The backward of ``forward``
(``api.operator``'s differentiable apply) gives ``values.grad`` and the
input's gradient.  ``update_values`` re-samples a dense weight on the
fixed mask, refills the tables and writes the parameter in place.
``EHYBLinear`` is the layer pinned to the uniform EHYB format.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .ehyb import EHYB
from .matrices import SparseCSR, from_coo


def _host_ehyb_of(op) -> Optional[EHYB]:
    """The host EHYB build behind a bound operator of the EHYB family
    (memoized in its plan's cache, so asking again builds nothing); None
    for the other formats, which build none."""
    from ..autotune.registry import get_format

    if not get_format(op.format).partitioned:
        return None
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
    """y = W_pruned x over the last axis of x, W bound as ``op``; the bound
    weights are the parameter ``values`` (see the module docstring)."""

    def __init__(self, d_in: int, d_out: int, op, density: float,
                 csr: Optional[SparseCSR] = None,
                 ehyb: Optional[EHYB] = None):
        super().__init__()
        self.d_in = d_in
        self.d_out = d_out
        self.op = op
        self.density = density
        self.csr = csr          # host mask, values of the last host bind
        self.ehyb = ehyb        # host EHYB build (EHYB family), else None
        self.values = nn.Parameter(op.values.detach().clone())
        self._bound = self._stamp()   # the parameter as ``op`` holds it

    def _stamp(self) -> tuple:
        v = self.values
        return (id(v), v._version, v.data_ptr())

    def _sync(self) -> None:
        """Rebind ``op`` to the parameter when it changed since ``op`` was
        bound (see the module docstring): a device scatter into new value
        tables on the same structure."""
        stamp = self._stamp()
        if stamp != self._bound:
            self.op = self.op.plan.bind(self.values.detach().clone(),
                                        dtype=self.op.dtype)
            self._bound = stamp

    def extra_repr(self) -> str:
        return (f"d_in={self.d_in}, d_out={self.d_out}, "
                f"density={self.density}, format={self.op.format!r}")

    def update_values(self, w: np.ndarray) -> "SparseLinear":
        """Same pruning mask, new weights, in place: the dense ``(d_out,
        d_in)`` matrix ``w`` re-sampled at the kept positions, bound by a
        refill of the operator's value tables (``op.update_values``: no
        partitioning, no build, no packing; the structure shared) and
        written into ``values``.  A stored weight that becomes zero keeps
        its slot.  Returns the layer."""
        w = np.asarray(w)
        if w.shape != (self.d_out, self.d_in):
            raise ValueError(f"weights {w.shape} != "
                             f"({self.d_out}, {self.d_in})")
        m = self.op.plan.pattern
        rows = np.repeat(np.arange(m.n), m.row_lengths())
        csr = SparseCSR(m.n, m.indptr, m.indices,
                        np.asarray(w, np.float64)[rows, m.indices])
        self.op = self.op.update_values(csr)
        self.csr = csr
        with torch.no_grad():
            self.values.copy_(self.op.values)
        self._bound = self._stamp()
        return self

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
        self._sync()
        return self.apply_with(self.op.obj, x, space)

    def apply_with(self, obj, x, space: str = "original") -> torch.Tensor:
        """``forward`` with an explicit device container ``obj`` of the
        operator's format (the same structure, other values), through the
        plan's guard, as given (``forward`` passes the operator's, rebound
        to ``values`` first).  Gradients reach x and, when ``obj`` is the
        layer's own, ``values``."""
        from ..api.operator import apply_operator

        op = self.op
        values = self.values if obj is op.obj else None
        if not isinstance(x, torch.Tensor):
            x = op._promote(x)
        lead = x.shape[:-1]
        permuted = space == "permuted"
        if permuted and not self.supports_permuted:
            raise ValueError(f"format {op.format!r} has no permuted space")
        xt = x.reshape(-1, op.n_pad).T if permuted else \
            self._embed(x.reshape(-1, self.d_in).T)           # (n, T)
        yt = apply_operator(op.plan, obj, op.dtype, xt, values, permuted)
        if permuted:
            return yt.T.reshape(*lead, op.n_pad)
        return yt[: self.d_out].T.reshape(*lead, self.d_out)

    def bytes_vs_dense(self, val_bytes: int = 4) -> dict:
        """Modeled bytes of one original-space apply (boundary permutes
        paid, ER fused) against the dense weight's: the host EHYB build's
        accounting, or the format's byte model when it builds none."""
        from ..autotune.cost import estimate_bytes

        dense = self.d_in * self.d_out * val_bytes
        if self.ehyb is not None:
            sparse = self.ehyb.bytes_moved(val_bytes, space="original",
                                           fused_er=True)["total"]
        else:
            sparse = estimate_bytes(self.csr, self.op.format, val_bytes)
        return {"dense": dense, "format": self.op.format,
                "sparse": sparse, "ehyb": sparse, "ratio": sparse / dense}


    @classmethod
    def from_dense(cls, w: np.ndarray, density: float = 0.1,
                   format: str = "auto", dtype=torch.float32,
                   partition_method: Optional[str] = None,
                   mesh=None, mesh_axis: str = "data", device=None,
                   **build_kw) -> "SparseLinear":
        """Deprecated: use :func:`repro_torch.api.pruned_linear` (the same
        pruning; the operator is planned and bound through
        ``repro_torch.api.plan``).  ``build_kw`` are ``pruned_linear``'s
        other keywords (``mode``, ``candidates``, ``k``)."""
        import warnings

        warnings.warn(
            "SparseLinear.from_dense is deprecated; use "
            "repro_torch.api.pruned_linear(w, density, ...)",
            DeprecationWarning, stacklevel=2)
        from ..api.nn import pruned_linear

        return pruned_linear(w, density, format=format, dtype=dtype,
                             partition_method=partition_method, mesh=mesh,
                             mesh_axis=mesh_axis, cls=cls, device=device,
                             **build_kw)


class EHYBLinear(SparseLinear):
    """The paper's layer: SparseLinear pinned to the EHYB format."""

    @classmethod
    def from_dense(cls, w: np.ndarray, density: float = 0.1,
                   method: str = "bfs", dtype=torch.float32,
                   device=None) -> "EHYBLinear":
        from ..api.nn import pruned_linear

        return pruned_linear(w, density, format="ehyb", dtype=dtype,
                             partition_method=method, cls=cls, device=device)

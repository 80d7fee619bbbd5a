"""EHYB device containers and the plain PyTorch SpMV paths.

The port of ``repro.core.spmv`` for the EHYB family: the containers carry
the same fields as the JAX package's ``EHYBDevice``/``EHYBPackedDevice``, as
tensors on one device, and the plain applies compute the same products with
plain tensor ops.  The plain paths are the oracle for the hand-written
kernels (``repro_torch.kernels``) and the apply the registered ``ehyb``
format runs, as the JAX package's XLA path is.

Column indices stay ``torch.uint16`` on the device (paper §3.4); the plain
code widens them with ``.to(torch.int64)`` because ``index_select`` and
``gather`` refuse uint16.  Products accumulate in fp32 (fp64 for fp64
tables) and come back in x's dtype, as the kernels do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .ehyb import EHYB, PackedEHYB, group_er_by_partition


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (``dtype`` casts floats)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


@dataclasses.dataclass
class EHYBDevice:
    """Device-side EHYB (uniform tiles), fields as in the JAX package.

    Besides the global ER tables, the container carries the ER slots
    regrouped by owning partition (``er_p_*``, from
    :func:`repro_torch.core.ehyb.group_er_by_partition`) so the fused
    kernel — and the plain path mirroring it — accumulate ER rows inside the
    block that owns them.  ``has_er`` lets both skip the ER stage on
    ER-free matrices.
    """

    n: int
    n_pad: int
    n_parts: int
    vec_size: int
    has_er: bool
    ell_vals: torch.Tensor    # (P, V, W)
    ell_cols: torch.Tensor    # (P, V, W) uint16 local
    er_vals: torch.Tensor     # (R, We)
    er_cols: torch.Tensor     # (R, We) int32 global-new
    er_row_idx: torch.Tensor  # (R,) int32
    er_p_vals: torch.Tensor   # (P, E, We) — ER grouped by owning partition
    er_p_cols: torch.Tensor   # (P, E, We) int32 global-new
    er_p_rows: torch.Tensor   # (P, E) int32 local row within the partition
    perm: torch.Tensor        # (n_pad,) int64
    inv_perm: torch.Tensor    # (n_pad,) int64

    @classmethod
    def from_ehyb(cls, e: EHYB, dtype=torch.float32, *,
                  device) -> "EHYBDevice":
        g = group_er_by_partition(e)
        return cls(e.n, e.n_pad, e.n_parts, e.vec_size, g["has_er"],
                   _tensor(e.ell_vals, device, dtype),
                   _tensor(e.ell_cols, device),
                   _tensor(e.er_vals, device, dtype),
                   _tensor(e.er_cols, device),
                   _tensor(e.er_row_idx, device),
                   _tensor(g["er_p_vals"], device, dtype),
                   _tensor(g["er_p_cols"], device),
                   _tensor(g["er_p_rows"], device),
                   _tensor(e.perm, device), _tensor(e.inv_perm, device))

    def value_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The value tables the apply reads: ELL tiles and grouped ER."""
        return self.ell_vals, self.er_p_vals


@dataclasses.dataclass
class EHYBPackedDevice:
    """Device-side packed-staircase EHYB, fields as in the JAX package."""

    n: int
    n_pad: int
    n_parts: int
    vec_size: int
    has_er: bool
    packed_vals: torch.Tensor   # (P, L)
    packed_cols: torch.Tensor   # (P, L) uint16
    col_starts: torch.Tensor    # (P, W+1) int32
    col_rows: torch.Tensor      # (P, W) int32, non-increasing along W
    er_vals: torch.Tensor
    er_cols: torch.Tensor
    er_row_idx: torch.Tensor
    er_p_vals: torch.Tensor     # (P, E, We) fused-ER tiles (see EHYBDevice)
    er_p_cols: torch.Tensor
    er_p_rows: torch.Tensor
    perm: torch.Tensor
    inv_perm: torch.Tensor

    @classmethod
    def from_packed(cls, pk: PackedEHYB, dtype=torch.float32, *,
                    device) -> "EHYBPackedDevice":
        e = pk.base
        g = group_er_by_partition(e)
        return cls(e.n, e.n_pad, e.n_parts, e.vec_size, g["has_er"],
                   _tensor(pk.packed_vals, device, dtype),
                   _tensor(pk.packed_cols, device),
                   _tensor(pk.col_starts, device),
                   _tensor(pk.col_rows, device),
                   _tensor(e.er_vals, device, dtype),
                   _tensor(e.er_cols, device),
                   _tensor(e.er_row_idx, device),
                   _tensor(g["er_p_vals"], device, dtype),
                   _tensor(g["er_p_cols"], device),
                   _tensor(g["er_p_rows"], device),
                   _tensor(e.perm, device), _tensor(e.inv_perm, device))

    def value_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The value tables the apply reads: staircase and grouped ER."""
        return self.packed_vals, self.er_p_vals


def value_index(e: EHYB, pk: Optional[PackedEHYB] = None) -> np.ndarray:
    """Where each nonzero's value lives in a bound container: (nnz,) int64
    positions, in CSR order, into the concatenation of the flattened
    ``value_tables()`` of the container built from ``e`` — the packed
    staircase ``pk`` of ``e`` or, when None, the uniform tiles — then the
    grouped ER tiles.

    Replays the build's own scatters — ``e.fill_plan`` (ELL and ER), the
    staircase packing (column k of partition p starts at
    ``col_starts[p, k]``) and the ER grouping — which depend on the pattern
    alone, so the index holds for every bind of the pattern.  Each value is
    read once: from the grouped ER tiles the apply reads, never from the
    global ER copy beside them."""
    fp = e.fill_plan
    v, w = e.vec_size, e.ell_width
    rows, k = np.divmod(fp["ell_dst"], w)
    if pk is not None:
        part = rows // v
        ell_pos = part * pk.packed_len + pk.col_starts[part, k] + rows % v
        n_ell = e.n_parts * pk.packed_len
    else:
        ell_pos, n_ell = fp["ell_dst"], e.n_pad * w
    g = group_er_by_partition(e)
    ep, we = g["er_p_vals"].shape[1:]
    grouped_row = np.empty(e.er_rows, dtype=np.int64)
    grouped_row[g["src"]] = g["own"] * ep + g["slot"]
    slot, kk = np.divmod(fp["er_dst"], we)
    idx = np.empty(e.nnz, dtype=np.int64)
    idx[fp["ell_src"]] = ell_pos
    idx[fp["er_src"]] = n_ell + grouped_row[slot] * we + kk
    return idx


# ---------------------------------------------------------------------------
# space helpers
# ---------------------------------------------------------------------------

def _as_2d(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if x.dim() == 1:
        return x[:, None], True
    return x, False


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: fp32, or fp64 for fp64 operands."""
    return torch.promote_types(dtype, torch.float32)


def _to_permuted(obj, x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Original (n[,R]) vector(s) -> permuted padded (n_pad[,R]) space."""
    x2, squeeze = _as_2d(x)
    pad = x2.new_zeros((obj.n_pad - obj.n, x2.shape[1]))
    return torch.cat([x2, pad], dim=0)[obj.perm], squeeze


def _from_permuted(obj, y_new: torch.Tensor, squeeze: bool) -> torch.Tensor:
    y = y_new[obj.inv_perm[: obj.n]]
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# plain applies
# ---------------------------------------------------------------------------

def _ehyb_ell_part(ell_vals, ell_cols, x_parts):
    """Cached part: per-partition gather from the partition's own x-slice.

    ell_vals/ell_cols (P, V, W); x_parts (P, V, R) -> (P, V, R) in the
    accumulation dtype."""
    p, v, w = ell_cols.shape
    r = x_parts.shape[2]
    acc = _acc_dtype(x_parts.dtype)
    idx = ell_cols.to(torch.int64).reshape(p, v * w, 1).expand(p, v * w, r)
    g = torch.gather(x_parts, 1, idx).reshape(p, v, w, r)
    return torch.einsum("pvw,pvwr->pvr", ell_vals.to(acc), g.to(acc))


def _fused_er_parts(x_new, er_p_vals, er_p_cols, er_p_rows, vec_size):
    """Per-partition ER contribution in (P, V, R) layout — the transparent
    form of the fused kernel's ER stage: each partition gathers its own ER
    rows from the full x and scatters them LOCALLY into its (V, R) output
    tile.  No global scatter-add."""
    p, e, we = er_p_vals.shape
    r = x_new.shape[1]
    acc = _acc_dtype(x_new.dtype)
    g = x_new.index_select(0, er_p_cols.reshape(-1).to(torch.int64))
    ye = torch.einsum("pew,pewr->per", er_p_vals.to(acc),
                      g.reshape(p, e, we, r).to(acc))
    rows = er_p_rows.to(torch.int64)[:, :, None].expand(p, e, r)
    out = torch.zeros((p, vec_size, r), dtype=acc, device=x_new.device)
    return out.scatter_add_(1, rows, ye)


def coo_spmv(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x2: torch.Tensor, n: int) -> torch.Tensor:
    """Plain COO product y = A x2: x2 (n, R) gathered by ``cols``, scaled by
    ``vals`` and summed into ``rows`` with ``index_add_`` (int64 index
    tensors on x2's device); accumulated in fp32 (fp64 for fp64), returned
    in x2's dtype.  On CUDA ``index_add_`` sums with atomics, so the result
    is not bit-reproducible from run to run."""
    acc = _acc_dtype(torch.promote_types(vals.dtype, x2.dtype))
    contrib = vals[:, None].to(acc) * x2.index_select(0, cols).to(acc)
    y = torch.zeros((n, x2.shape[1]), dtype=acc, device=x2.device)
    return y.index_add_(0, rows, contrib).to(x2.dtype)


def ehyb_spmv_permuted(m: EHYBDevice, x_new: torch.Tensor) -> torch.Tensor:
    """EHYB SpMV/SpMM in the permuted space: x_new, y_new are (n_pad[, R]).

    The hot-loop form: no pad, no ``perm``/``inv_perm`` gathers, ER fused
    into the per-partition accumulation (oracle for the fused kernel)."""
    x2, squeeze = _as_2d(x_new)
    r = x2.shape[1]
    x_parts = x2.reshape(m.n_parts, m.vec_size, r)
    y_parts = _ehyb_ell_part(m.ell_vals, m.ell_cols, x_parts)
    if m.has_er:
        y_parts = y_parts + _fused_er_parts(x2, m.er_p_vals, m.er_p_cols,
                                            m.er_p_rows, m.vec_size)
    y_new = y_parts.reshape(m.n_pad, r).to(x2.dtype)
    return y_new[:, 0] if squeeze else y_new


def ehyb_spmv(m: EHYBDevice, x: torch.Tensor) -> torch.Tensor:
    """Plain EHYB SpMV/SpMM in the ORIGINAL space: one permuted-space apply
    bracketed by the per-call perm / inv_perm gathers that
    :func:`ehyb_spmv_permuted` lets solvers hoist."""
    x_new, squeeze = _to_permuted(m, x)
    y_new = ehyb_spmv_permuted(m, x_new)
    return _from_permuted(m, y_new, squeeze)

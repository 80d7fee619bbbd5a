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

from .ehyb import EHYB, PackedEHYB, er_stream, group_er_by_partition

ER_STREAM = ("er_s_part_ptr", "er_s_row_ptr", "er_s_rows", "er_s_cols",
             "er_s_vals")


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (``dtype`` casts floats)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def column_rows(e: EHYB) -> np.ndarray:
    """(P, W) int32: how many rows of each partition hold an entry in ELL
    column k — the staircase's ``col_rows``, from the pattern's row widths
    (rows are width-sorted, so they are the prefix ``[0, col_rows[p, k])``
    and row i's width is the number of k with ``col_rows[p, k] > i``)."""
    widths = e.fill_plan["ell_widths"].reshape(e.n_parts, e.vec_size)
    ks = np.arange(e.ell_width)[None, None, :]
    return (widths[:, :, None] > ks).sum(axis=1).astype(np.int32)


def er_column_rows(e: EHYB) -> np.ndarray:
    """(W,) int32: how many rows of the global ``(Rr, W)`` ER table hold
    more than k live entries — ``er_col_rows``, from the pattern
    (``fill_plan["er_dst"]``), never from the values, so a stored zero
    keeps its entry.  The build sorts the ER rows by descending live count
    and fills each row's live entries as a prefix, so row r's live count
    is the number of k with ``er_col_rows[k] > r``; raises if the table is
    not laid out so."""
    if e.fill_plan is None:
        raise ValueError("er_col_rows is laid out from the pattern: the "
                         "build has no fill_plan")
    w = e.er_width
    dst = e.fill_plan["er_dst"]
    live = np.bincount(dst // w, minlength=e.er_rows)
    out = (live[None, :] > np.arange(w)[:, None]).sum(axis=1).astype(
        np.int32)
    prefix = np.arange(w)[None, :] < live[:, None]          # (Rr, W)
    if (np.diff(out) > 0).any() or not np.array_equal(
            (out[None, :] > np.arange(e.er_rows)[:, None]).sum(axis=1),
            live) or not np.array_equal(np.sort(dst),
                                        np.flatnonzero(prefix)):
        raise ValueError("the ER table's live entries are not prefixes of "
                         "rows in descending length")
    return out


def er_stream_tensors(e, er_p_vals: torch.Tensor,
                      er_p_cols: torch.Tensor) -> dict:
    """The compact ER stream of host build ``e``
    (:func:`repro_torch.core.ehyb.er_stream`) as the containers' ``er_s_*``
    tensors, on the tiles' device: the pointers and local rows from the
    pattern, the values and columns gathered from the ``(P, E, We)`` tiles
    (so they equal the tiles' bit for bit).  Raises unless the tiles have
    the shape of ``e``'s grouping, which the gather positions index."""
    s = er_stream(e)
    if tuple(er_p_vals.shape) != s["tile_shape"] or \
            er_p_cols.shape != er_p_vals.shape:
        raise ValueError(f"the ER tiles are {tuple(er_p_vals.shape)} and "
                         f"{tuple(er_p_cols.shape)}; the host build groups "
                         f"its ER rows as {s['tile_shape']}")
    dev = er_p_vals.device
    pos = _tensor(s["pos"], dev)
    return {"er_s_part_ptr": _tensor(s["part_ptr"], dev),
            "er_s_row_ptr": _tensor(s["row_ptr"], dev),
            "er_s_rows": _tensor(s["rows"], dev),
            "er_s_cols": er_p_cols.reshape(-1).index_select(0, pos),
            "er_s_vals": er_p_vals.reshape(-1).index_select(0, pos)}


@dataclasses.dataclass
class EHYBDevice:
    """Device-side EHYB (uniform tiles), fields as in the JAX package.

    Besides the global ER tables, the container carries the ER slots
    regrouped by owning partition (``er_p_*``, from
    :func:`repro_torch.core.ehyb.group_er_by_partition`) so the fused
    kernels — and the plain paths mirroring them — accumulate ER rows
    inside the block that owns them.  ``has_er`` lets both skip the ER
    stage on ER-free matrices.

    Fields the JAX container lacks (device layouts of the same operator,
    laid out from the pattern of a host build):

    * ``er_s_*`` — the compact ER stream (:func:`repro_torch.core.ehyb.
      er_stream`): the live ER entries only, grouped by partition, with a
      row pointer and a local row per live ER row.  The fused SpMV and
      SpMM kernels read it instead of the padded ``er_p_*`` tiles, which
      the unfused level, the plain paths and :meth:`value_tables` still
      read.
    * ``col_rows`` — (P, W) rows per ELL column (:func:`column_rows`), from
      which the SpMV kernels take each row's width and skip the tile's
      padded tail.
    * ``er_col_rows`` — (We,) rows of the global ER table per column
      (:func:`er_column_rows`), from which the standalone ER kernel takes
      each row's live prefix.
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
    er_s_part_ptr: torch.Tensor  # (P+1,) int32
    er_s_row_ptr: torch.Tensor   # (Rlive+1,) int32
    er_s_rows: torch.Tensor      # (Rlive,) int32 local rows
    er_s_cols: torch.Tensor      # (nnz_er,) int32 global-new
    er_s_vals: torch.Tensor      # (nnz_er,) table dtype
    col_rows: torch.Tensor       # (P, W) int32 rows per ELL column
    er_col_rows: torch.Tensor    # (We,) int32 ER rows per ER column

    @classmethod
    def from_ehyb(cls, e: EHYB, dtype=torch.float32, *,
                  device) -> "EHYBDevice":
        g = group_er_by_partition(e)
        er_p_vals = _tensor(g["er_p_vals"], device, dtype)
        er_p_cols = _tensor(g["er_p_cols"], device)
        return cls(e.n, e.n_pad, e.n_parts, e.vec_size, g["has_er"],
                   _tensor(e.ell_vals, device, dtype),
                   _tensor(e.ell_cols, device),
                   _tensor(e.er_vals, device, dtype),
                   _tensor(e.er_cols, device),
                   _tensor(e.er_row_idx, device),
                   er_p_vals, er_p_cols,
                   _tensor(g["er_p_rows"], device),
                   _tensor(e.perm, device), _tensor(e.inv_perm, device),
                   **er_stream_tensors(e, er_p_vals, er_p_cols),
                   col_rows=_tensor(column_rows(e), device),
                   er_col_rows=_tensor(er_column_rows(e), device))

    def er_stream(self) -> tuple:
        """The compact ER stream, in ``ER_STREAM`` order."""
        return tuple(getattr(self, f) for f in ER_STREAM)

    def value_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The value tables the apply reads: ELL tiles and grouped ER."""
        return self.ell_vals, self.er_p_vals


@dataclasses.dataclass
class EHYBPackedDevice:
    """Device-side packed-staircase EHYB, fields as in the JAX package,
    plus the compact ER stream ``er_s_*``, which the fused SpMV and SpMM
    kernels read, and ``er_col_rows`` (see :class:`EHYBDevice`)."""

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
    er_s_part_ptr: torch.Tensor
    er_s_row_ptr: torch.Tensor
    er_s_rows: torch.Tensor
    er_s_cols: torch.Tensor
    er_s_vals: torch.Tensor
    er_col_rows: torch.Tensor

    @classmethod
    def from_packed(cls, pk: PackedEHYB, dtype=torch.float32, *,
                    device) -> "EHYBPackedDevice":
        e = pk.base
        g = group_er_by_partition(e)
        er_p_vals = _tensor(g["er_p_vals"], device, dtype)
        er_p_cols = _tensor(g["er_p_cols"], device)
        return cls(e.n, e.n_pad, e.n_parts, e.vec_size, g["has_er"],
                   _tensor(pk.packed_vals, device, dtype),
                   _tensor(pk.packed_cols, device),
                   _tensor(pk.col_starts, device),
                   _tensor(pk.col_rows, device),
                   _tensor(e.er_vals, device, dtype),
                   _tensor(e.er_cols, device),
                   _tensor(e.er_row_idx, device),
                   er_p_vals, er_p_cols,
                   _tensor(g["er_p_rows"], device),
                   _tensor(e.perm, device), _tensor(e.inv_perm, device),
                   **er_stream_tensors(e, er_p_vals, er_p_cols),
                   er_col_rows=_tensor(er_column_rows(e), device))

    def er_stream(self) -> tuple:
        """The compact ER stream, in ``ER_STREAM`` order."""
        return tuple(getattr(self, f) for f in ER_STREAM)

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

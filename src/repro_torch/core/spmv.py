"""Device containers and the plain PyTorch SpMV paths of every format.

The port of ``repro.core.spmv``: each container carries the same fields as
the JAX package's (``COODevice``, ``ELLDevice``, ``HYBDevice``,
``EHYBDevice``, ``EHYBBucketsDevice``, ``EHYBPackedDevice``; the dense
format gets a small :class:`DenseDevice` where the reference keeps a bare
array), as tensors on one device, and the plain applies compute the same
products with plain tensor ops.  The EHYB plain paths are the oracle for
the hand-written kernels (``repro_torch.kernels``); they and the applies
of ``csr``, ``ell``, ``hyb``, ``ehyb_bucketed`` and ``dense`` are what
those registered formats run, as the JAX package's XLA paths are (none of
them has a Pallas kernel there).

Column indices of the EHYB tiles stay ``torch.uint16`` on the device (paper
§3.4); the plain code widens them with ``.to(torch.int64)`` because
``index_select`` and ``gather`` refuse uint16.  Products accumulate in fp32
(fp64 for fp64 tables) and come back in x's dtype, as the kernels do.  The
gathered intermediates of the ELL-style applies are accumulated over row
(or partition) chunks, so their size stays bounded at any matrix size; the
sums are the same.

Every container names its value tensors (``VALUE_FIELDS``): the new
formats fill them from the per-nnz values through a pattern-only index
(:func:`fill_values`), at the first bind and at every rebind alike.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch

from .ehyb import (EHYB, EHYBBuckets, PackedEHYB, er_stream,
                   group_er_by_partition)
from .matrices import SparseCSR

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
    VALUE_FIELDS: ClassVar[tuple] = ("ell_vals", "er_vals", "er_p_vals",
                                     "er_s_vals")

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
    kernels read, and ``er_col_rows`` (see :class:`EHYBDevice`).

    ``rhs_chunk`` is the tuned rhs chunk width the SpMM kernels sweep K in
    (``tuning.TunedParams.rhs_chunk``; None: the kernels' default), the
    counterpart of the reference container's ``kparams``."""

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
    rhs_chunk: Optional[int] = None
    VALUE_FIELDS: ClassVar[tuple] = ("packed_vals", "er_vals", "er_p_vals",
                                     "er_s_vals")

    @classmethod
    def from_packed(cls, pk: PackedEHYB, dtype=torch.float32, *,
                    device, rhs_chunk: Optional[int] = None
                    ) -> "EHYBPackedDevice":
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
                   er_col_rows=_tensor(er_column_rows(e), device),
                   rhs_chunk=rhs_chunk)

    def er_stream(self) -> tuple:
        """The compact ER stream, in ``ER_STREAM`` order."""
        return tuple(getattr(self, f) for f in ER_STREAM)

    def value_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The value tables the apply reads: staircase and grouped ER."""
        return self.packed_vals, self.er_p_vals


def value_fields(obj) -> tuple[str, ...]:
    """The names of a container's value tensors (``VALUE_FIELDS``; for the
    EHYB containers the ELL tiles or the staircase, ``er_vals``, the
    grouped tiles ``er_p_vals`` and the compact stream's ``er_s_vals``).
    Every other tensor field is structure."""
    return type(obj).VALUE_FIELDS


def placeholder(shape, dtype, device) -> torch.Tensor:
    """A value table's stand-in: one zero expanded to ``shape`` (what
    :func:`structure_of` puts in a value field)."""
    return torch.zeros((), dtype=dtype, device=device).expand(shape)


def structure_of(obj):
    """``obj`` with each value tensor replaced by a placeholder of its
    shape, dtype and device that holds one element (a zero expanded to the
    shape): the structure a plan keeps to scatter later binds into
    (:func:`scatter_values`), holding no value table alive."""
    return dataclasses.replace(obj, **{
        f: placeholder(t.shape, t.dtype, t.device)
        for f, t in ((f, getattr(obj, f)) for f in value_fields(obj))})


def value_scatter_index(e: EHYB, pk: Optional[PackedEHYB] = None) -> dict:
    """Where each nonzero's value goes in every value table of the
    container built from ``e`` (the staircase ``pk`` of ``e`` or, when
    None, the uniform tiles): {table: (dst, src)} flat positions in the
    table and CSR positions in the value stream, for ``main`` (the ELL
    tiles or staircase), ``er_p_vals`` and ``er_vals``, plus ``pos``, the
    compact stream's positions in the grouped tiles.  From the pattern
    alone, so it holds for every bind of it (see :func:`value_index`)."""
    idx = value_index(e, pk)
    n_main = e.n_parts * pk.packed_len if pk is not None else \
        e.n_pad * e.ell_width
    in_main = idx < n_main
    src_main, src_er = np.flatnonzero(in_main), np.flatnonzero(~in_main)
    fp = e.fill_plan
    return {"main": (idx[src_main], src_main),
            "er_p_vals": (idx[src_er] - n_main, src_er),
            "er_vals": (fp["er_dst"], fp["er_src"]),
            "pos": er_stream(e)["pos"]}


def scatter_values(obj, vals: torch.Tensor, index: dict):
    """``obj`` with its four value tables filled from the per-nnz values
    ``vals`` (CSR order, on the container's device, in the table dtype)
    through :func:`value_scatter_index`'s ``index`` (as tensors on that
    device); the structural tensors are shared.  Only the value tables'
    shapes are read from ``obj``, so it may be :func:`structure_of` a
    container."""
    main = value_fields(obj)[0]
    new = {}
    for name, key in ((main, "main"), ("er_p_vals", "er_p_vals"),
                      ("er_vals", "er_vals")):
        dst, src = index[key]
        flat = vals.new_zeros(getattr(obj, name).numel())
        flat[dst] = vals[src]
        new[name] = flat.view(getattr(obj, name).shape)
    new["er_s_vals"] = new["er_p_vals"].reshape(-1).index_select(
        0, index["pos"])
    return dataclasses.replace(obj, **new)


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

# elements of a gathered (rows, W, R) intermediate one chunk of an
# ELL-style plain apply holds (64 MiB in fp32)
_CHUNK_ELEMS = 1 << 24


def _chunks(n: int, per_item: int):
    """Slices of ``range(n)`` whose items, ``per_item`` elements each, fill
    at most :data:`_CHUNK_ELEMS` (at least one item a chunk)."""
    step = max(1, _CHUNK_ELEMS // max(per_item, 1))
    return [slice(s, min(s + step, n)) for s in range(0, n, step)]


def _ehyb_ell_part(ell_vals, ell_cols, x_parts):
    """Cached part: per-partition gather from the partition's own x-slice.

    ell_vals/ell_cols (P, V, W); x_parts (P, V, R) -> (P, V, R) in the
    accumulation dtype, over chunks of partitions."""
    p, v, w = ell_cols.shape
    r = x_parts.shape[2]
    acc = _acc_dtype(x_parts.dtype)
    out = torch.empty((p, v, r), dtype=acc, device=x_parts.device)
    for c in _chunks(p, v * w * r):
        cols = ell_cols[c]
        idx = cols.to(torch.int64).reshape(-1, v * w, 1).expand(-1, v * w, r)
        g = torch.gather(x_parts[c], 1, idx).reshape(-1, v, w, r)
        out[c] = torch.einsum("pvw,pvwr->pvr", ell_vals[c].to(acc),
                              g.to(acc))
    return out


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


def _coo_acc(rows, cols, vals, x2, n: int) -> torch.Tensor:
    """:func:`coo_product` before the cast back: (n, R) in the accumulation
    dtype, the (nnz, R) products formed over chunks of entries."""
    acc = _acc_dtype(torch.promote_types(vals.dtype, x2.dtype))
    y = torch.zeros((n, x2.shape[1]), dtype=acc, device=x2.device)
    for c in _chunks(vals.shape[0], x2.shape[1]):
        contrib = vals[c, None].to(acc) * x2.index_select(0, cols[c]).to(acc)
        y.index_add_(0, rows[c], contrib)
    return y


def coo_product(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                x2: torch.Tensor, n: int) -> torch.Tensor:
    """Plain COO product y = A x2: x2 (n, R) gathered by ``cols``, scaled by
    ``vals`` and summed into ``rows`` with ``index_add_`` (int32 or int64
    index tensors on x2's device); accumulated in fp32 (fp64 for fp64),
    returned in x2's dtype.  On CUDA ``index_add_`` sums with atomics, so
    the result is not bit-reproducible from run to run.  The guard's
    reference level and the ``csr`` format's apply (:func:`coo_spmv`)."""
    return _coo_acc(rows, cols, vals, x2, n).to(x2.dtype)


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


# ---------------------------------------------------------------------------
# the formats without a partition: csr, ell, hyb, dense
# ---------------------------------------------------------------------------

def _values(m: SparseCSR, dtype, device) -> torch.Tensor:
    """The per-nnz values of ``m`` (CSR order) on ``device`` in ``dtype``,
    converted as :meth:`~repro_torch.api.Plan.bind` converts them."""
    return torch.from_numpy(np.ascontiguousarray(m.data)).to(
        device=device, dtype=dtype)


def csr_slots(m: SparseCSR) -> tuple[np.ndarray, np.ndarray]:
    """(row, k) of each CSR entry: its row and its slot within the row
    (the reference's ``_csr_scatter``; callers mask k against their table
    width)."""
    lens = m.row_lengths()
    rows = np.repeat(np.arange(m.n), lens)
    start = np.concatenate([[0], np.cumsum(lens)])
    return rows, np.arange(m.nnz) - start[rows]


def hyb_width(m: SparseCSR, frac: float = 0.9) -> int:
    """HYB's ELL width: the ``frac`` quantile of the row lengths (so that
    that share of rows fits in ELL), at least 1."""
    lens = m.row_lengths()
    return max(int(np.quantile(lens, frac)) if m.n else 1, 1)


def fill_values(obj, vals: torch.Tensor, index: dict):
    """``obj`` with the value tables named in ``index`` filled from the
    per-nnz values ``vals`` (CSR order, on the container's device, in the
    table dtype); every other field shared.

    ``index`` maps a field to its rounds ``((dst, src), ...)`` of device
    index tensors: round 0 writes ``table.flat[dst] = vals[src]``, each
    later round adds its values into the positions it names.  No round
    names a position twice, so the fill is deterministic; duplicate entries
    of a pattern (the dense format's) sum over rounds in CSR order.  Only
    the tables' shapes are read from ``obj``, so it may be
    :func:`structure_of` a container."""
    new = {}
    for name, rounds in index.items():
        t = getattr(obj, name)
        flat = vals.new_zeros(t.numel())
        for r, (dst, src) in enumerate(rounds):
            if r == 0:
                flat[dst] = vals[src]
            else:
                flat[dst] += vals[src]
        new[name] = flat.view(t.shape)
    return dataclasses.replace(obj, **new)


def index_positions(index: dict, obj, nnz: int) -> np.ndarray:
    """(nnz,) positions (CSR order) of each value in the concatenation of
    ``obj``'s flattened value tables plus one trailing zero, from a host
    :func:`fill_values` index: a value written by round 0 of its table is
    read there; one folded into another (a duplicate entry, summed into
    its first) reads the trailing zero, so a product over the positions
    counts each table entry once."""
    sizes = [getattr(obj, f).numel() for f in value_fields(obj)]
    pos = np.full(nnz, sum(sizes), dtype=np.int64)
    off = 0
    for f, size in zip(value_fields(obj), sizes):
        if index.get(f):
            dst, src = index[f][0]
            pos[src] = off + dst
        off += size
    return pos


@dataclasses.dataclass
class COODevice:
    """The ``csr`` format: per-nnz row, column and value streams in CSR
    order (a gather and a segment sum)."""

    n: int
    rows: torch.Tensor   # (nnz,) int32
    cols: torch.Tensor   # (nnz,) int32
    vals: torch.Tensor   # (nnz,)
    VALUE_FIELDS: ClassVar[tuple] = ("vals",)

    @classmethod
    def structure(cls, m: SparseCSR, dtype, *, device) -> "COODevice":
        rows = np.repeat(np.arange(m.n, dtype=np.int32), m.row_lengths())
        return cls(m.n, _tensor(rows, device), _tensor(m.indices, device),
                   placeholder((m.nnz,), dtype, device))

    @staticmethod
    def index(m: SparseCSR) -> dict:
        src = np.arange(m.nnz, dtype=np.int64)
        return {"vals": ((src, src),)}

    def value_tables(self) -> tuple:
        return (self.vals,)


@dataclasses.dataclass
class ELLDevice:
    """ELLPACK padded to the global max row width (padding: value 0,
    column 0)."""

    n: int
    vals: torch.Tensor   # (n, W)
    cols: torch.Tensor   # (n, W) int32 (global)
    VALUE_FIELDS: ClassVar[tuple] = ("vals",)

    @classmethod
    def structure(cls, m: SparseCSR, dtype, *, device) -> "ELLDevice":
        w = max(int(m.row_lengths().max()) if m.n else 1, 1)
        rows, k = csr_slots(m)
        cols = np.zeros((m.n, w), dtype=np.int32)
        cols[rows, k] = m.indices
        return cls(m.n, placeholder((m.n, w), dtype, device),
                   _tensor(cols, device))

    @staticmethod
    def index(m: SparseCSR) -> dict:
        w = max(int(m.row_lengths().max()) if m.n else 1, 1)
        rows, k = csr_slots(m)
        return {"vals": ((rows * w + k, np.arange(m.nnz, dtype=np.int64)),)}

    def value_tables(self) -> tuple:
        return (self.vals,)


@dataclasses.dataclass
class HYBDevice:
    """Classic HYB (Bell & Garland 2009): ELL up to the 90th-percentile row
    width K, the rest of each longer row in a COO spill."""

    n: int
    ell_vals: torch.Tensor   # (n, K)
    ell_cols: torch.Tensor   # (n, K) int32
    coo_rows: torch.Tensor   # (S,) int32
    coo_cols: torch.Tensor   # (S,) int32
    coo_vals: torch.Tensor   # (S,)
    VALUE_FIELDS: ClassVar[tuple] = ("ell_vals", "coo_vals")

    @classmethod
    def structure(cls, m: SparseCSR, dtype, *, device) -> "HYBDevice":
        kq = hyb_width(m)
        rows, k = csr_slots(m)
        in_ell = k < kq
        cols = np.zeros((m.n, kq), dtype=np.int32)
        cols[rows[in_ell], k[in_ell]] = m.indices[in_ell]
        spill = int((~in_ell).sum())
        return cls(m.n, placeholder((m.n, kq), dtype, device),
                   _tensor(cols, device),
                   _tensor(rows[~in_ell].astype(np.int32), device),
                   _tensor(m.indices[~in_ell], device),
                   placeholder((spill,), dtype, device))

    @staticmethod
    def index(m: SparseCSR) -> dict:
        kq = hyb_width(m)
        rows, k = csr_slots(m)
        in_ell = k < kq
        src = np.arange(m.nnz, dtype=np.int64)
        spill = src[~in_ell]
        return {"ell_vals": ((rows[in_ell] * kq + k[in_ell], src[in_ell]),),
                "coo_vals": ((np.arange(len(spill), dtype=np.int64),
                              spill),)}

    def value_tables(self) -> tuple:
        return (self.ell_vals, self.coo_vals)


@dataclasses.dataclass
class DenseDevice:
    """The ``dense`` format: the (n, n) matrix, duplicate entries summed
    (the reference binds a bare array; the port's value machinery needs a
    container)."""

    n: int
    vals: torch.Tensor   # (n, n)
    VALUE_FIELDS: ClassVar[tuple] = ("vals",)

    @classmethod
    def structure(cls, m: SparseCSR, dtype, *, device) -> "DenseDevice":
        return cls(m.n, placeholder((m.n, m.n), dtype, device))

    @staticmethod
    def index(m: SparseCSR) -> dict:
        """Round r holds each position's (r+1)-th entry in CSR order."""
        rows, _ = csr_slots(m)
        pos = rows * m.n + m.indices.astype(np.int64)
        order = np.argsort(pos, kind="stable")
        sp = pos[order]
        first = np.ones(m.nnz, dtype=bool)
        first[1:] = sp[1:] != sp[:-1]
        group_start = np.maximum.accumulate(
            np.where(first, np.arange(m.nnz), 0))
        rank = np.empty(m.nnz, dtype=np.int64)
        rank[order] = np.arange(m.nnz) - group_start
        src = np.arange(m.nnz, dtype=np.int64)
        return {"vals": tuple((pos[rank == r], src[rank == r])
                              for r in range(int(rank.max()) + 1
                                             if m.nnz else 1))}

    def value_tables(self) -> tuple:
        return (self.vals,)


def _ell_rows(vals, cols, x2) -> torch.Tensor:
    """Σ_w vals[i, w]·x2[cols[i, w]] for every row i, over row chunks:
    (n, R) in the accumulation dtype."""
    n, w = cols.shape
    r = x2.shape[1]
    acc = _acc_dtype(torch.promote_types(vals.dtype, x2.dtype))
    y = torch.empty((n, r), dtype=acc, device=x2.device)
    for c in _chunks(n, w * r):
        g = x2.index_select(0, cols[c].reshape(-1)).reshape(-1, w, r)
        y[c] = torch.einsum("nw,nwr->nr", vals[c].to(acc), g.to(acc))
    return y


def coo_spmv(m: COODevice, x: torch.Tensor) -> torch.Tensor:
    """The ``csr`` format's apply: x (n,) or (n, R)."""
    x2, squeeze = _as_2d(x)
    y = coo_product(m.rows, m.cols, m.vals, x2, m.n)
    return y[:, 0] if squeeze else y


def ell_spmv(m: ELLDevice, x: torch.Tensor) -> torch.Tensor:
    """ELL apply: x (n,) or (n, R)."""
    x2, squeeze = _as_2d(x)
    y = _ell_rows(m.vals, m.cols, x2).to(x2.dtype)
    return y[:, 0] if squeeze else y


def hyb_spmv(m: HYBDevice, x: torch.Tensor) -> torch.Tensor:
    """HYB apply: the ELL part, plus the COO spill summed into its rows."""
    x2, squeeze = _as_2d(x)
    y = _ell_rows(m.ell_vals, m.ell_cols, x2)
    y = y + _coo_acc(m.coo_rows, m.coo_cols, m.coo_vals, x2, m.n)
    y = y.to(x2.dtype)
    return y[:, 0] if squeeze else y


def dense_spmv(m: DenseDevice, x: torch.Tensor) -> torch.Tensor:
    """Dense apply: one matmul in the accumulation dtype."""
    x2, squeeze = _as_2d(x)
    acc = _acc_dtype(torch.promote_types(m.vals.dtype, x2.dtype))
    y = (m.vals.to(acc) @ x2.to(acc)).to(x2.dtype)
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# width-bucketed EHYB
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EHYBBucketsDevice:
    """Device-side width-bucketed EHYB (the reference's
    ``EHYBBucketsDevice``): per bucket its partitions and a uniform
    (B_i, V, W_i) tile, plus the grouped ER tiles and the permutation.

    The buckets' value tiles are one flat tensor, ``vals`` (bucket i's
    tile is the i-th slice, :meth:`bucket_vals`), so a rebind is one
    scatter per table like every other format's."""

    n: int
    n_pad: int
    n_parts: int
    vec_size: int
    has_er: bool
    widths: tuple            # per-bucket tile widths
    part_ids: tuple          # per bucket (B_i,) int64 partition ids
    vals: torch.Tensor       # every bucket's (B_i, V, W_i) tile, flattened
    cols: tuple              # per bucket (B_i, V, W_i) uint16 local
    er_p_vals: torch.Tensor  # (P, E, We) — ER grouped by owning partition
    er_p_cols: torch.Tensor
    er_p_rows: torch.Tensor
    perm: torch.Tensor       # (n_pad,) int64
    inv_perm: torch.Tensor   # (n_pad,) int64
    VALUE_FIELDS: ClassVar[tuple] = ("vals", "er_p_vals")

    @classmethod
    def structure(cls, b: EHYBBuckets, dtype, *,
                  device) -> "EHYBBucketsDevice":
        e = b.base
        g = group_er_by_partition(e)
        n_vals = sum(v.size for v in b.vals)
        return cls(e.n, e.n_pad, e.n_parts, e.vec_size, g["has_er"],
                   tuple(b.widths),
                   tuple(_tensor(p.astype(np.int64), device)
                         for p in b.part_ids),
                   placeholder((n_vals,), dtype, device),
                   tuple(_tensor(c, device) for c in b.cols),
                   placeholder(g["er_p_vals"].shape, dtype, device),
                   _tensor(g["er_p_cols"], device),
                   _tensor(g["er_p_rows"], device),
                   _tensor(e.perm, device), _tensor(e.inv_perm, device))

    @staticmethod
    def index(b: EHYBBuckets) -> dict:
        """Each entry's slot in its bucket's tile (from ``fill_plan``'s ELL
        scatter) and in the grouped ER tiles."""
        e = b.base
        fp = e.fill_plan
        v, w = e.vec_size, e.ell_width
        bucket = np.empty(e.n_parts, dtype=np.int64)
        slot = np.empty(e.n_parts, dtype=np.int64)
        offs = np.cumsum([0] + [t.size for t in b.vals])
        for i, pid in enumerate(b.part_ids):
            bucket[pid] = i
            slot[pid] = np.arange(len(pid))
        row, k = np.divmod(fp["ell_dst"], w)
        part, local = np.divmod(row, v)
        wb = np.asarray(b.widths, dtype=np.int64)[bucket[part]]
        dst = offs[bucket[part]] + (slot[part] * v + local) * wb + k
        er = value_scatter_index(e)["er_p_vals"]
        return {"vals": ((dst, fp["ell_src"]),), "er_p_vals": (er,)}

    def bucket_vals(self) -> list:
        """Bucket i's (B_i, V, W_i) value tile, a view into ``vals``."""
        out, off = [], 0
        for c in self.cols:
            out.append(self.vals[off: off + c.numel()].view(c.shape))
            off += c.numel()
        return out

    def value_tables(self) -> tuple:
        return (self.vals, self.er_p_vals)


def ehyb_buckets_spmv_permuted(m: EHYBBucketsDevice,
                               x_new: torch.Tensor) -> torch.Tensor:
    """Bucketed EHYB SpMV/SpMM in the permuted space: each bucket's tiles
    on its partitions' x-slices, then the fused per-partition ER part."""
    x2, squeeze = _as_2d(x_new)
    r = x2.shape[1]
    acc = _acc_dtype(x2.dtype)
    x_parts = x2.reshape(m.n_parts, m.vec_size, r)
    y_parts = torch.zeros((m.n_parts, m.vec_size, r), dtype=acc,
                          device=x2.device)
    for pid, vals, cols in zip(m.part_ids, m.bucket_vals(), m.cols):
        y_parts.index_copy_(0, pid, _ehyb_ell_part(
            vals, cols, x_parts.index_select(0, pid)).to(acc))
    if m.has_er:
        y_parts = y_parts + _fused_er_parts(x2, m.er_p_vals, m.er_p_cols,
                                            m.er_p_rows, m.vec_size)
    y_new = y_parts.reshape(m.n_pad, r).to(x2.dtype)
    return y_new[:, 0] if squeeze else y_new


def ehyb_buckets_spmv(m: EHYBBucketsDevice, x: torch.Tensor) -> torch.Tensor:
    """Bucketed EHYB SpMV/SpMM, original space."""
    x_new, squeeze = _to_permuted(m, x)
    return _from_permuted(m, ehyb_buckets_spmv_permuted(m, x_new), squeeze)

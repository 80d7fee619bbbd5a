"""Wrappers of the EHYB SpMV kernels (``csrc/ehyb_spmv.cu``).

``ehyb_fused`` replaces ``repro.kernels.ehyb_spmv.ehyb_fused_pallas``
(uniform (V, W) tiles) and ``ehyb_packed_fused`` replaces
``ehyb_packed_fused_pallas`` (packed staircase, the native apply of the
``ehyb_packed`` format).  Both compute y_new = A x_new in the permuted
space, one thread block per partition, and read the partition's ER rows
from the compact ER stream (``EHYBDevice.er_s_*``: the live entries only,
a row pointer and a local row per live ER row), not from the padded
``er_p_*`` tiles, which the unfused level and the plain paths read.
``ehyb_ell`` and ``ehyb_ell_packed`` replace ``ehyb_ell_pallas`` and
``ehyb_ell_packed_pallas``: the cached (sliced-ELL) part alone, the
guarded apply's unfused level at one right-hand side; they are the fused
kernels' bodies without the ER stage.  ``er`` replaces ``er_pallas``: the
uncached ER rows as per-slot partial sums, which the caller scatter-adds
by ``er_row_idx``; it reads each row's live prefix only, its width from
``er_col_rows``.

What bounds them is device-memory bytes, and with one block a partition,
the bytes each SM keeps in flight.  The packed kernel gives a thread to a
row of the staircase (coalesced along each column) with 8 independent
loads in flight; the uniform kernels give a group of lanes (4 in #1, 8 in
#4) to a row of the row-major tile and read it to the row's width, which
they take from ``col_rows``; the ER stage gives 4 lanes to an ER row of
the stream, and ``er`` 4 lanes to a row of the ER table.  The group widths
are fixed in the CUDA source, and each body picks its block size there.
Every sum runs in a fixed order (shuffle reductions, a plain add of each
ER row into the block's tile, no atomics), so two launches give the same
bits.  The CUDA source says more.

For tensors on the CPU each wrapper runs its plain version
(``kernels.ref``; the fused ones on the same compact stream); for CUDA
tensors it checks what the kernel takes, launches it on the current
stream, raises on a launch error and adds one to its ``launches`` count.
It never falls back.

The SpMV and ELL-only kernels take one right-hand side (R = 1), fp32 or
bf16 tables with x in the same dtype, and fp32 accumulation.  A batch
(R ≥ 2) raises ``NotImplementedError`` here: ``kernels.ops`` sends it to
the SpMM kernels (``kernels.ehyb_spmm``).  ``er`` takes any R ≥ 1.  fp64
raises ``TypeError``.
"""

from __future__ import annotations

import functools

import torch

from . import build
from .ref import (ehyb_ell_packed_ref, ehyb_ell_ref, ehyb_fused_stream_ref,
                  ehyb_packed_fused_stream_ref, er_live_ref)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PACKED_DTYPES = {"packed_cols": torch.uint16, "col_starts": torch.int32,
                  "col_rows": torch.int32}


def _check_tables(x: torch.Tensor, vals: torch.Tensor, dtypes: dict,
                  tables: list) -> None:
    """The checks every EHYB kernel's wrapper makes before a launch: x on a
    Hopper card, fp32 or bf16 tables, x in the tables' dtype, and each
    table of its dtype, on x's device and contiguous."""
    from .ops import check_cuda_device

    check_cuda_device(x.device)
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA EHYB kernels take float32 or bfloat16 "
                        f"tables, got {vals.dtype}")
    if x.dtype != vals.dtype:
        raise TypeError(f"x is {x.dtype} but the tables are {vals.dtype}")
    for name, t in tables:
        want = dtypes.get(name)
        if want is not None and t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(x_new: torch.Tensor, vals: torch.Tensor, n_pad: int,
           dtypes: dict, tables: list) -> torch.Tensor:
    """Validate a CUDA SpMV launch; returns x_new as a contiguous (n_pad,)
    view.  A batch of R ≥ 2 columns belongs to the SpMM kernels
    (``kernels.ehyb_spmm``), which ``kernels.ops`` routes it to."""
    if x_new.dim() == 2:
        if x_new.shape[1] != 1:
            raise NotImplementedError(
                f"the CUDA SpMV kernels take one right-hand side; got "
                f"{x_new.shape[1]} (kernels.ehyb_spmm takes a batch)")
        x_new = x_new[:, 0]
    if x_new.shape != (n_pad,):
        raise ValueError(f"x_new has shape {tuple(x_new.shape)}, "
                         f"expected ({n_pad},)")
    _check_tables(x_new, vals, dtypes, tables)
    return x_new.contiguous()


@functools.cache
def _smem_optin(index: int) -> int:
    """Opt-in shared memory per block of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _smem_and_stage(device: torch.device, v: int, itemsize: int,
                    acc_bytes: int, n_meta: int) -> int:
    """Whether the block's ``n_meta`` int32 of row metadata (``col_rows``,
    and ``col_starts`` for the staircase) go into shared memory beside the
    (V,) x-slice and the fp32 output tile (``acc_bytes`` a row; 0 for the
    ELL-only kernels, which keep no tile); without room the kernel reads
    them through L1.  Raises when the tiles alone exceed the opt-in shared
    memory of one block."""
    smem = v * (acc_bytes + itemsize)
    limit = _smem_optin(device.index)
    if smem > limit:
        raise ValueError(f"vec_size {v} needs {smem} bytes of shared memory "
                         f"per block; the card allows {limit}")
    return int(smem + 4 * n_meta <= limit)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _stream_tables(er_stream: tuple, p: int, vals: torch.Tensor) -> list:
    """The compact ER stream's (name, tensor) pairs for ``_check``; raises
    on inconsistent shapes."""
    part_ptr, row_ptr, rows, cols, er_vals = er_stream
    n_rows, nnz = rows.shape[0], cols.shape[0]
    if part_ptr.shape != (p + 1,) or row_ptr.shape != (n_rows + 1,) \
            or rows.shape != (n_rows,) or cols.shape != (nnz,) \
            or er_vals.shape != (nnz,):
        raise ValueError("inconsistent compact ER stream shapes")
    return [("er_s_part_ptr", part_ptr), ("er_s_row_ptr", row_ptr),
            ("er_s_rows", rows), ("er_s_cols", cols), ("er_s_vals", er_vals)]


def _stream_dtypes(vals: torch.Tensor) -> dict:
    return {"er_s_part_ptr": torch.int32, "er_s_row_ptr": torch.int32,
            "er_s_rows": torch.int32, "er_s_cols": torch.int32,
            "er_s_vals": vals.dtype}


def _ptrs(tables: list) -> list:
    return [t.data_ptr() for _, t in tables]


def _check_uniform(ell_vals: torch.Tensor, ell_cols: torch.Tensor,
                   col_rows: torch.Tensor) -> tuple:
    """The uniform tiles' shapes and ``col_rows``' dtype, checked on every
    device (the plain versions read each row to its width as well); returns
    (P, V, W)."""
    if ell_vals.dim() != 3 or ell_cols.shape != ell_vals.shape:
        raise ValueError(f"ell_vals and ell_cols must be (P, V, W) alike; "
                         f"got {tuple(ell_vals.shape)} and "
                         f"{tuple(ell_cols.shape)}")
    p, v, w = ell_vals.shape
    if col_rows.shape != (p, w):
        raise ValueError(f"col_rows has shape {tuple(col_rows.shape)}, "
                         f"expected ({p}, {w})")
    if col_rows.dtype != torch.int32:
        raise TypeError(f"col_rows must be torch.int32, got {col_rows.dtype}")
    return p, v, w


def ehyb_fused(x_new: torch.Tensor, ell_vals: torch.Tensor,
               ell_cols: torch.Tensor, col_rows: torch.Tensor,
               er_stream: tuple, has_er: bool = True) -> torch.Tensor:
    """Fused uniform-tile EHYB SpMV, permuted space: y_new (n_pad[, 1]).

    x_new (n_pad,) or (n_pad, 1); ell_vals/ell_cols (P, V, W) with uint16
    local columns; ``col_rows`` (P, W) int32 rows per ELL column
    (``EHYBDevice.col_rows``), from which the kernel takes each row's width
    and so skips the tile's padded tail; ``er_stream`` the compact ER
    stream, the five ``EHYBDevice.er_s_*`` tensors in
    ``core.spmv.ER_STREAM`` order."""
    p, v, w = _check_uniform(ell_vals, ell_cols, col_rows)
    if x_new.device.type == "cpu":
        squeeze = x_new.dim() == 1
        y = ehyb_fused_stream_ref(x_new[:, None] if squeeze else x_new,
                                  ell_vals, ell_cols, col_rows, er_stream,
                                  has_er)
        return y[:, 0] if squeeze else y
    er_tables = _stream_tables(er_stream, p, ell_vals)
    tables = [("ell_vals", ell_vals), ("ell_cols", ell_cols),
              ("col_rows", col_rows)]
    x = _check(x_new, ell_vals, p * v,
               {"ell_cols": torch.uint16, **_stream_dtypes(ell_vals)},
               tables + er_tables)
    stage = _smem_and_stage(x.device, v, x.element_size(), 4, w)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmv", "ehyb_fused", 10, 6)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
             *_ptrs(tables), *_ptrs(er_tables), p, v, w,
             er_stream[2].shape[0], int(has_er), stage,
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "ehyb_fused")
    ehyb_fused.launches += 1
    return y if x_new.dim() == 1 else y[:, None]


ehyb_fused.launches = 0


def ehyb_packed_fused(x_new: torch.Tensor, packed_vals: torch.Tensor,
                      packed_cols: torch.Tensor, col_starts: torch.Tensor,
                      col_rows: torch.Tensor, er_stream: tuple, *,
                      vec_size: int, has_er: bool = True) -> torch.Tensor:
    """Fused packed-staircase EHYB SpMV, permuted space: y_new (n_pad[, 1]).

    packed_vals/packed_cols (P, L); col_starts (P, W+1) and col_rows (P, W)
    int32, col_rows non-increasing along W; ``er_stream`` as in
    :func:`ehyb_fused`."""
    if x_new.device.type == "cpu":
        squeeze = x_new.dim() == 1
        y = ehyb_packed_fused_stream_ref(
            x_new[:, None] if squeeze else x_new, packed_vals, packed_cols,
            col_starts, col_rows, er_stream, vec_size, has_er)
        return y[:, 0] if squeeze else y
    p, l = packed_vals.shape
    w = col_rows.shape[1]
    er_tables = _stream_tables(er_stream, p, packed_vals)
    x = _check(x_new, packed_vals, p * vec_size,
               {**_PACKED_DTYPES, **_stream_dtypes(packed_vals)},
               [("packed_vals", packed_vals), ("packed_cols", packed_cols),
                ("col_starts", col_starts), ("col_rows", col_rows)]
               + er_tables)
    if packed_cols.shape != (p, l) or col_starts.shape != (p, w + 1) \
            or col_rows.shape != (p, w):
        raise ValueError("inconsistent packed EHYB shapes")
    stage = _smem_and_stage(x.device, vec_size, x.element_size(), 4,
                            2 * w + 1)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmv", "ehyb_packed_fused", 11, 7)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
             packed_vals.data_ptr(), packed_cols.data_ptr(),
             col_starts.data_ptr(), col_rows.data_ptr(), *_ptrs(er_tables),
             p, vec_size, l, w, er_stream[2].shape[0], int(has_er), stage,
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "ehyb_packed_fused")
    ehyb_packed_fused.launches += 1
    return y if x_new.dim() == 1 else y[:, None]


ehyb_packed_fused.launches = 0


def _one_rhs_parts(x_parts: torch.Tensor, p: int, v: int) -> torch.Tensor:
    """x_parts (P, V) or (P, V, 1) as a (P, V) view; a batch belongs to the
    ELL-only SpMM kernels (``kernels.ehyb_spmm``)."""
    if x_parts.dim() == 3:
        if x_parts.shape[2] != 1:
            raise NotImplementedError(
                f"the ELL-only SpMV kernels take one right-hand side; got "
                f"{x_parts.shape[2]} (kernels.ehyb_spmm takes a batch)")
        x_parts = x_parts[..., 0]
    if x_parts.shape != (p, v):
        raise ValueError(f"x_parts has shape {tuple(x_parts.shape)}, "
                         f"expected ({p}, {v})")
    return x_parts


def _cpu_parts(ref_fn, x_parts: torch.Tensor, *tables) -> torch.Tensor:
    """The plain (P, V, K) version on a (P, V) or (P, V, K) x_parts."""
    flat = x_parts.dim() == 2
    y = ref_fn(x_parts[..., None] if flat else x_parts, *tables)
    return y[..., 0] if flat else y


def ehyb_ell(x_parts: torch.Tensor, ell_vals: torch.Tensor,
             ell_cols: torch.Tensor, col_rows: torch.Tensor) -> torch.Tensor:
    """Cached (sliced-ELL) part alone on uniform tiles: y_parts of
    x_parts's shape, (P, V) or (P, V, 1).

    ell_vals/ell_cols (P, V, W) with uint16 local columns; ``col_rows`` as
    in :func:`ehyb_fused`."""
    p, v, w = _check_uniform(ell_vals, ell_cols, col_rows)
    if x_parts.device.type == "cpu":
        return _cpu_parts(ehyb_ell_ref, x_parts, ell_vals, ell_cols,
                          col_rows)
    x = _one_rhs_parts(x_parts, p, v)
    tables = [("ell_vals", ell_vals), ("ell_cols", ell_cols),
              ("col_rows", col_rows)]
    _check_tables(x, ell_vals, {"ell_cols": torch.uint16}, tables)
    x = x.contiguous()
    stage = _smem_and_stage(x.device, v, x.element_size(), 0, w)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmv", "ehyb_ell", 5, 4)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
             *_ptrs(tables), p, v, w, stage,
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "ehyb_ell")
    ehyb_ell.launches += 1
    return y.view(x_parts.shape)


ehyb_ell.launches = 0


def ehyb_ell_packed(x_parts: torch.Tensor, packed_vals: torch.Tensor,
                    packed_cols: torch.Tensor, col_starts: torch.Tensor,
                    col_rows: torch.Tensor) -> torch.Tensor:
    """Cached part alone on the packed staircase: y_parts of x_parts's
    shape, (P, V) or (P, V, 1).

    packed_vals/packed_cols (P, L); col_starts (P, W+1) and col_rows (P, W)
    int32, col_rows non-increasing along W."""
    if x_parts.device.type == "cpu":
        return _cpu_parts(ehyb_ell_packed_ref, x_parts, packed_vals,
                          packed_cols, col_starts, col_rows)
    p, l = packed_vals.shape
    w = col_rows.shape[1]
    v = x_parts.shape[1]
    x = _one_rhs_parts(x_parts, p, v)
    _check_tables(x, packed_vals, _PACKED_DTYPES,
                  [("packed_vals", packed_vals), ("packed_cols", packed_cols),
                   ("col_starts", col_starts), ("col_rows", col_rows)])
    if packed_cols.shape != (p, l) or col_starts.shape != (p, w + 1) \
            or col_rows.shape != (p, w):
        raise ValueError("inconsistent packed EHYB shapes")
    x = x.contiguous()
    stage = _smem_and_stage(x.device, v, x.element_size(), 0, 2 * w + 1)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmv", "ehyb_ell_packed", 6, 5)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
             packed_vals.data_ptr(), packed_cols.data_ptr(),
             col_starts.data_ptr(), col_rows.data_ptr(), p, v, l, w, stage,
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "ehyb_ell_packed")
    ehyb_ell_packed.launches += 1
    return y.view(x_parts.shape)


ehyb_ell_packed.launches = 0


def er(x_new: torch.Tensor, er_vals: torch.Tensor, er_cols: torch.Tensor,
       er_col_rows: torch.Tensor) -> torch.Tensor:
    """Uncached ER rows -> per-slot partial sums: (Rr,) for x_new (n_pad,),
    (Rr, R) for x_new (n_pad, R), in x's dtype.

    er_vals/er_cols (Rr, W) with int32 global columns (``EHYBDevice.er_*``);
    ``er_col_rows`` (W,) int32, the rows with more than k live entries
    (``EHYBDevice.er_col_rows``): the kernel reads each row's live prefix
    only, once for all R columns, and writes 0 for rows with none.  The
    caller adds row e's partial into ``y_new[er_row_idx[e]]``.  With finite
    x this equals the padded table's product (``ref.er_ref``); see
    ``ref.er_live_ref`` for a non-finite ``x[0]``."""
    squeeze = x_new.dim() == 1
    x2 = x_new[:, None] if squeeze else x_new
    if er_vals.dim() != 2 or er_cols.shape != er_vals.shape \
            or er_col_rows.shape != (er_vals.shape[1],):
        raise ValueError(f"er_vals and er_cols must be (Rr, W) alike and "
                         f"er_col_rows (W,); got {tuple(er_vals.shape)}, "
                         f"{tuple(er_cols.shape)} and "
                         f"{tuple(er_col_rows.shape)}")
    if x_new.device.type == "cpu":
        y = er_live_ref(x2, er_vals, er_cols, er_col_rows)
        return y[:, 0] if squeeze else y
    if x2.dim() != 2:
        raise ValueError(f"x_new must be (n_pad,) or (n_pad, R), got "
                         f"{tuple(x_new.shape)}")
    tables = [("er_vals", er_vals), ("er_cols", er_cols),
              ("er_col_rows", er_col_rows)]
    _check_tables(x2, er_vals, {"er_cols": torch.int32,
                                "er_col_rows": torch.int32}, tables)
    rr, w = er_vals.shape
    r = x2.shape[1]
    x2 = x2.contiguous()
    out = torch.empty((rr, r), dtype=x2.dtype, device=x2.device)
    fn = build.entry("ehyb_spmv", "er", 5, 3)
    err = fn(_DTYPE_CODE[x2.dtype], x2.data_ptr(), out.data_ptr(),
             *_ptrs(tables), rr, w, r,
             torch.cuda.current_stream(x2.device).cuda_stream)
    _raise_on(err, "er")
    er.launches += 1
    return out[:, 0] if squeeze else out


er.launches = 0

"""Wrappers of the EHYB SpMM kernels (``csrc/ehyb_spmm.cu``): the multi-rhs
apply Y = A X in the permuted space.

Each replaces one Pallas kernel of ``repro.kernels.ehyb_spmm``:

``ehyb_fused_spmm``        ``ehyb_fused_spmm_pallas`` — uniform (V, W) tiles
                           and the partition's own ER rows, (n_pad, K);
``ehyb_packed_fused_spmm`` ``ehyb_packed_fused_spmm_pallas`` — the packed
                           staircase and ER, the native batched apply of
                           ``ehyb_packed``;
``ehyb_ell_spmm``          ``ehyb_ell_spmm_pallas`` — uniform tiles alone,
                           (P, V, K) -> (P, V, K);
``ehyb_ell_packed_spmm``   ``ehyb_ell_packed_spmm_pallas`` — the staircase
                           alone.

The fused kernels read each partition's ER rows from the compact ER stream
(``EHYBDevice.er_s_*``: the live entries only), as the fused SpMV kernels
do, never the padded ``er_p_*`` tiles.  Every kernel takes each row's width
from ``col_rows`` (P, W) and reads the row to that width only: the packed
ones a thread a row down the staircase's columns, the uniform ones a group
of lanes a row of the row-major tile.  The CUDA source picks each block's
size.

One thread block per partition sweeps the K columns in chunks of Kc:
``rhs_chunk`` (None = :data:`SPMM_RHS_CHUNK`, as in the reference), cut to
what the partition's (V, Kc) x tile and fp32 output tile leave of the
block's shared memory, and to :data:`MAX_RHS_CHUNK`, the widest register
accumulator the kernels are built with.  The uniform ELL-only kernel keeps
no output tile (it writes each row's sums straight to y) and so holds less
shared memory, at the same Kc.  The chunk width changes the
number of passes over A, never the result: each column's sum runs in the
same order whatever the chunks, and two launches give the same bits.

For tensors on the CPU each wrapper runs its plain version
(``kernels.ref``; the fused ones on the same compact stream); for CUDA
tensors it checks what the kernel takes (the checks of
``kernels.ehyb_spmv``), makes X contiguous, launches on the current
stream, raises on a launch error and adds one to its ``launches``
count.  It never falls back.  Tables are fp32 or bf16, X in their dtype;
accumulation is fp32.
"""

from __future__ import annotations

import torch

from . import build
from .ehyb_spmv import (_DTYPE_CODE, _check_tables, _check_uniform, _ptrs,
                        _raise_on, _smem_optin, _stream_dtypes,
                        _stream_tables)
from .ref import (ehyb_ell_packed_ref, ehyb_ell_ref, ehyb_fused_stream_ref,
                  ehyb_packed_fused_stream_ref)

# rhs columns per chunk by default (repro/kernels/ehyb_spmm.py:36)
SPMM_RHS_CHUNK = 16
# the widest register accumulator csrc/ehyb_spmm.cu instantiates
MAX_RHS_CHUNK = 32


def _requested_chunk(rhs_chunk) -> int:
    chunk = SPMM_RHS_CHUNK if rhs_chunk is None else rhs_chunk
    if not isinstance(chunk, int) or not 1 <= chunk <= MAX_RHS_CHUNK:
        raise ValueError(f"rhs_chunk must be an int in [1, {MAX_RHS_CHUNK}], "
                         f"got {rhs_chunk!r}")
    return chunk


def rhs_chunk_for(k: int, v: int, itemsize: int, rhs_chunk, smem: int) -> int:
    """Kc: the rhs columns one block sweeps at a time for a (V = ``v``) x
    tile of ``itemsize``-byte values, given ``smem`` bytes of shared memory
    a block; raises when not even one column fits."""
    fit = smem // (v * (itemsize + 4))
    if fit < 1:
        raise ValueError(f"vec_size {v} needs {v * (itemsize + 4)} bytes of "
                         f"shared memory per rhs column; the card allows "
                         f"{smem} a block")
    return min(k, _requested_chunk(rhs_chunk), fit)


def _prepare(x: torch.Tensor, shape: tuple, vals: torch.Tensor, dtypes: dict,
             tables: list, v: int, rhs_chunk, n_meta: int, tile: bool = True):
    """Check a CUDA launch; returns (contiguous x, Kc, stage): ``stage`` = 1
    when the ``n_meta`` int32 of row metadata (``col_rows``, and
    ``col_starts`` for the staircase) fit in shared memory beside the
    tiles the kernel holds — the (V, Kc) x tile, and the fp32 output tile
    unless ``tile`` is False."""
    if tuple(x.shape) != shape or shape[-1] < 1:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"{shape[:-1] + ('K',)} with K ≥ 1")
    _check_tables(x, vals, dtypes, tables)
    smem = _smem_optin(x.device.index)
    kc = rhs_chunk_for(shape[-1], v, x.element_size(), rhs_chunk, smem)
    held = v * kc * (x.element_size() + (4 if tile else 0))
    return x.contiguous(), kc, int(held + 4 * n_meta <= smem)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


_PACKED_DTYPES = {"packed_cols": torch.uint16, "col_starts": torch.int32,
                  "col_rows": torch.int32}


def _check_packed(packed_vals, packed_cols, col_starts, col_rows):
    p, l = packed_vals.shape
    w = col_rows.shape[1]
    if packed_cols.shape != (p, l) or col_starts.shape != (p, w + 1) \
            or col_rows.shape != (p, w):
        raise ValueError("inconsistent packed staircase shapes")
    return p, l, w


def ehyb_fused_spmm(x_new: torch.Tensor, ell_vals: torch.Tensor,
                    ell_cols: torch.Tensor, col_rows: torch.Tensor,
                    er_stream: tuple, *, rhs_chunk=None) -> torch.Tensor:
    """Fused uniform-tile EHYB SpMM, permuted space: y_new (n_pad, K).

    x_new (n_pad, K); ell_vals/ell_cols (P, V, W) with uint16 local
    columns; ``col_rows`` (P, W) int32 rows per ELL column
    (``EHYBDevice.col_rows``, non-increasing along W), from which the
    kernel takes each row's width and so reads no padded slot;
    ``er_stream`` the compact ER stream, the five ``EHYBDevice.er_s_*``
    tensors in ``core.spmv.ER_STREAM`` order (the live ER entries only)."""
    _requested_chunk(rhs_chunk)
    p, v, w = _check_uniform(ell_vals, ell_cols, col_rows)
    if x_new.device.type == "cpu":
        return ehyb_fused_stream_ref(x_new, ell_vals, ell_cols, col_rows,
                                     er_stream)
    er_tables = _stream_tables(er_stream, p, ell_vals)
    k = x_new.shape[-1]
    tables = [("ell_vals", ell_vals), ("ell_cols", ell_cols),
              ("col_rows", col_rows)]
    x, kc, stage = _prepare(
        x_new, (p * v, k), ell_vals,
        {"ell_cols": torch.uint16, **_stream_dtypes(ell_vals)},
        tables + er_tables, v, rhs_chunk, w)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmm", "ehyb_fused_spmm", 10, 7)
    _raise_on(fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                 *_ptrs(tables), *_ptrs(er_tables), p, v, w,
                 er_stream[2].shape[0], k, kc, stage, _stream(x)),
              "ehyb_fused_spmm")
    ehyb_fused_spmm.launches += 1
    return y


ehyb_fused_spmm.launches = 0


def ehyb_packed_fused_spmm(x_new: torch.Tensor, packed_vals: torch.Tensor,
                           packed_cols: torch.Tensor, col_starts: torch.Tensor,
                           col_rows: torch.Tensor, er_stream: tuple, *,
                           vec_size: int, rhs_chunk=None) -> torch.Tensor:
    """Fused packed-staircase EHYB SpMM, permuted space: y_new (n_pad, K).

    packed_vals/packed_cols (P, L); col_starts (P, W+1) and col_rows (P, W)
    int32, col_rows non-increasing along W; ``er_stream`` as in
    :func:`ehyb_fused_spmm`."""
    _requested_chunk(rhs_chunk)
    if x_new.device.type == "cpu":
        return ehyb_packed_fused_stream_ref(x_new, packed_vals, packed_cols,
                                            col_starts, col_rows, er_stream,
                                            vec_size)
    p, l, w = _check_packed(packed_vals, packed_cols, col_starts, col_rows)
    er_tables = _stream_tables(er_stream, p, packed_vals)
    k = x_new.shape[-1]
    tables = [("packed_vals", packed_vals), ("packed_cols", packed_cols),
              ("col_starts", col_starts), ("col_rows", col_rows)]
    x, kc, stage = _prepare(
        x_new, (p * vec_size, k), packed_vals,
        {**_PACKED_DTYPES, **_stream_dtypes(packed_vals)},
        tables + er_tables, vec_size, rhs_chunk, 2 * w + 1)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmm", "ehyb_packed_fused_spmm", 11, 8)
    _raise_on(fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                 *_ptrs(tables), *_ptrs(er_tables), p, vec_size, l, w,
                 er_stream[2].shape[0], k, kc, stage, _stream(x)),
              "ehyb_packed_fused_spmm")
    ehyb_packed_fused_spmm.launches += 1
    return y


ehyb_packed_fused_spmm.launches = 0


def ehyb_ell_spmm(x_parts: torch.Tensor, ell_vals: torch.Tensor,
                  ell_cols: torch.Tensor, col_rows: torch.Tensor, *,
                  rhs_chunk=None) -> torch.Tensor:
    """Cached (sliced-ELL) part alone, uniform tiles: x_parts (P, V, K) ->
    y_parts (P, V, K); ``col_rows`` as in :func:`ehyb_fused_spmm`."""
    _requested_chunk(rhs_chunk)
    p, v, w = _check_uniform(ell_vals, ell_cols, col_rows)
    if x_parts.device.type == "cpu":
        return ehyb_ell_ref(x_parts, ell_vals, ell_cols, col_rows)
    k = x_parts.shape[-1]
    tables = [("ell_vals", ell_vals), ("ell_cols", ell_cols),
              ("col_rows", col_rows)]
    x, kc, stage = _prepare(x_parts, (p, v, k), ell_vals,
                            {"ell_cols": torch.uint16}, tables, v, rhs_chunk,
                            w, tile=False)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmm", "ehyb_ell_spmm", 5, 6)
    _raise_on(fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                 *_ptrs(tables), p, v, w, k, kc, stage, _stream(x)),
              "ehyb_ell_spmm")
    ehyb_ell_spmm.launches += 1
    return y


ehyb_ell_spmm.launches = 0


def ehyb_ell_packed_spmm(x_parts: torch.Tensor, packed_vals: torch.Tensor,
                         packed_cols: torch.Tensor, col_starts: torch.Tensor,
                         col_rows: torch.Tensor, *,
                         rhs_chunk=None) -> torch.Tensor:
    """Cached part alone, packed staircase: x_parts (P, V, K) -> y_parts
    (P, V, K)."""
    _requested_chunk(rhs_chunk)
    if x_parts.device.type == "cpu":
        return ehyb_ell_packed_ref(x_parts, packed_vals, packed_cols,
                                   col_starts, col_rows)
    p, l, w = _check_packed(packed_vals, packed_cols, col_starts, col_rows)
    if x_parts.dim() != 3:
        raise ValueError(f"x_parts has shape {tuple(x_parts.shape)}, "
                         f"expected ({p}, V, K)")
    v, k = x_parts.shape[1:]
    tables = [("packed_vals", packed_vals), ("packed_cols", packed_cols),
              ("col_starts", col_starts), ("col_rows", col_rows)]
    x, kc, stage = _prepare(x_parts, (p, v, k), packed_vals, _PACKED_DTYPES,
                            tables, v, rhs_chunk, 2 * w + 1)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmm", "ehyb_ell_packed_spmm", 6, 7)
    _raise_on(fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                 *_ptrs(tables), p, v, l, w, k, kc, stage, _stream(x)),
              "ehyb_ell_packed_spmm")
    ehyb_ell_packed_spmm.launches += 1
    return y


ehyb_ell_packed_spmm.launches = 0

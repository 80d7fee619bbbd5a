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

One thread block per partition sweeps the K columns in chunks of Kc:
``rhs_chunk`` (None = :data:`SPMM_RHS_CHUNK`, as in the reference), cut to
what the partition's (V, Kc) x tile and fp32 output tile leave of the
block's shared memory, and to :data:`MAX_RHS_CHUNK`, the widest register
accumulator the kernels are built with.  The chunk width changes the
number of passes over A, never the result: each column's sum runs in the
same order whatever the chunks.

For tensors on the CPU each wrapper runs its plain version
(``kernels.ref``); for CUDA tensors it checks what the kernel takes (the
checks of ``kernels.ehyb_spmv``), makes X contiguous, launches on the
current stream, raises on a launch error and adds one to its ``launches``
count.  It never falls back.  Tables are fp32 or bf16, X in their dtype;
accumulation is fp32.
"""

from __future__ import annotations

import torch

from . import build
from .ehyb_spmv import _DTYPE_CODE, _check_tables, _raise_on, _smem_optin
from .ref import (ehyb_ell_packed_ref, ehyb_ell_ref, ehyb_fused_ref,
                  ehyb_packed_fused_ref)

# rhs columns per chunk by default (repro/kernels/ehyb_spmm.py:36)
SPMM_RHS_CHUNK = 16
# the widest register accumulator csrc/ehyb_spmm.cu instantiates
MAX_RHS_CHUNK = 32
_MAX_THREADS = 512


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
             tables: list, v: int, e: int, rhs_chunk):
    """Check a CUDA launch; returns (contiguous x, Kc, threads)."""
    if tuple(x.shape) != shape or shape[-1] < 1:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"{shape[:-1] + ('K',)} with K ≥ 1")
    _check_tables(x, vals, dtypes, tables)
    kc = rhs_chunk_for(shape[-1], v, x.element_size(), rhs_chunk,
                       _smem_optin(x.device.index))
    threads = min(_MAX_THREADS, max(32, -(-max(v, e) // 32) * 32))
    return x.contiguous(), kc, threads


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


_ER_DTYPES = {"er_p_cols": torch.int32, "er_p_rows": torch.int32}
_PACKED_DTYPES = {"packed_cols": torch.uint16, "col_starts": torch.int32,
                  "col_rows": torch.int32}


def _check_er(er_p_vals, er_p_cols, er_p_rows, p: int) -> tuple[int, int]:
    _, e, we = er_p_vals.shape
    if er_p_vals.shape[0] != p or er_p_cols.shape != er_p_vals.shape \
            or er_p_rows.shape != (p, e):
        raise ValueError("inconsistent ER tile shapes")
    return e, we


def _check_packed(packed_vals, packed_cols, col_starts, col_rows):
    p, l = packed_vals.shape
    w = col_rows.shape[1]
    if packed_cols.shape != (p, l) or col_starts.shape != (p, w + 1) \
            or col_rows.shape != (p, w):
        raise ValueError("inconsistent packed staircase shapes")
    return p, l, w


def ehyb_fused_spmm(x_new: torch.Tensor, ell_vals: torch.Tensor,
                    ell_cols: torch.Tensor, er_p_vals: torch.Tensor,
                    er_p_cols: torch.Tensor, er_p_rows: torch.Tensor, *,
                    rhs_chunk=None) -> torch.Tensor:
    """Fused uniform-tile EHYB SpMM, permuted space: y_new (n_pad, K).

    x_new (n_pad, K); ell_vals/ell_cols (P, V, W) with uint16 local
    columns; er_p_vals/er_p_cols (P, E, We) with int32 global columns;
    er_p_rows (P, E) int32 local rows."""
    _requested_chunk(rhs_chunk)
    if x_new.device.type == "cpu":
        return ehyb_fused_ref(x_new, ell_vals, ell_cols, er_p_vals,
                              er_p_cols, er_p_rows)
    p, v, w = ell_vals.shape
    e, we = _check_er(er_p_vals, er_p_cols, er_p_rows, p)
    if ell_cols.shape != ell_vals.shape:
        raise ValueError("inconsistent ELL tile shapes")
    k = x_new.shape[-1]
    x, kc, threads = _prepare(
        x_new, (p * v, k), ell_vals,
        {"ell_cols": torch.uint16, "er_p_vals": ell_vals.dtype, **_ER_DTYPES},
        [("ell_vals", ell_vals), ("ell_cols", ell_cols),
         ("er_p_vals", er_p_vals), ("er_p_cols", er_p_cols),
         ("er_p_rows", er_p_rows)], v, e, rhs_chunk)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmm", "ehyb_fused_spmm", 7, 8)
    _raise_on(fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                 ell_vals.data_ptr(), ell_cols.data_ptr(),
                 er_p_vals.data_ptr(), er_p_cols.data_ptr(),
                 er_p_rows.data_ptr(), p, v, w, e, we, k, kc, threads,
                 _stream(x)), "ehyb_fused_spmm")
    ehyb_fused_spmm.launches += 1
    return y


ehyb_fused_spmm.launches = 0


def ehyb_packed_fused_spmm(x_new: torch.Tensor, packed_vals: torch.Tensor,
                           packed_cols: torch.Tensor, col_starts: torch.Tensor,
                           col_rows: torch.Tensor, er_p_vals: torch.Tensor,
                           er_p_cols: torch.Tensor, er_p_rows: torch.Tensor,
                           *, vec_size: int, rhs_chunk=None) -> torch.Tensor:
    """Fused packed-staircase EHYB SpMM, permuted space: y_new (n_pad, K).

    packed_vals/packed_cols (P, L); col_starts (P, W+1) and col_rows (P, W)
    int32, col_rows non-increasing along W; ER tiles as in
    :func:`ehyb_fused_spmm`."""
    _requested_chunk(rhs_chunk)
    if x_new.device.type == "cpu":
        return ehyb_packed_fused_ref(x_new, packed_vals, packed_cols,
                                     col_starts, col_rows, er_p_vals,
                                     er_p_cols, er_p_rows, vec_size)
    p, l, w = _check_packed(packed_vals, packed_cols, col_starts, col_rows)
    e, we = _check_er(er_p_vals, er_p_cols, er_p_rows, p)
    k = x_new.shape[-1]
    x, kc, threads = _prepare(
        x_new, (p * vec_size, k), packed_vals,
        {**_PACKED_DTYPES, "er_p_vals": packed_vals.dtype, **_ER_DTYPES},
        [("packed_vals", packed_vals), ("packed_cols", packed_cols),
         ("col_starts", col_starts), ("col_rows", col_rows),
         ("er_p_vals", er_p_vals), ("er_p_cols", er_p_cols),
         ("er_p_rows", er_p_rows)], vec_size, e, rhs_chunk)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmm", "ehyb_packed_fused_spmm", 9, 9)
    _raise_on(fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                 packed_vals.data_ptr(), packed_cols.data_ptr(),
                 col_starts.data_ptr(), col_rows.data_ptr(),
                 er_p_vals.data_ptr(), er_p_cols.data_ptr(),
                 er_p_rows.data_ptr(), p, vec_size, l, w, e, we, k, kc,
                 threads, _stream(x)), "ehyb_packed_fused_spmm")
    ehyb_packed_fused_spmm.launches += 1
    return y


ehyb_packed_fused_spmm.launches = 0


def ehyb_ell_spmm(x_parts: torch.Tensor, ell_vals: torch.Tensor,
                  ell_cols: torch.Tensor, *, rhs_chunk=None) -> torch.Tensor:
    """Cached (sliced-ELL) part alone, uniform tiles: x_parts (P, V, K) ->
    y_parts (P, V, K)."""
    _requested_chunk(rhs_chunk)
    if x_parts.device.type == "cpu":
        return ehyb_ell_ref(x_parts, ell_vals, ell_cols)
    p, v, w = ell_vals.shape
    if ell_cols.shape != ell_vals.shape:
        raise ValueError("inconsistent ELL tile shapes")
    k = x_parts.shape[-1]
    x, kc, threads = _prepare(
        x_parts, (p, v, k), ell_vals, {"ell_cols": torch.uint16},
        [("ell_vals", ell_vals), ("ell_cols", ell_cols)], v, 0, rhs_chunk)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmm", "ehyb_ell_spmm", 4, 6)
    _raise_on(fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                 ell_vals.data_ptr(), ell_cols.data_ptr(), p, v, w, k, kc,
                 threads, _stream(x)), "ehyb_ell_spmm")
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
    x, kc, threads = _prepare(
        x_parts, (p, v, k), packed_vals, _PACKED_DTYPES,
        [("packed_vals", packed_vals), ("packed_cols", packed_cols),
         ("col_starts", col_starts), ("col_rows", col_rows)], v, 0,
        rhs_chunk)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmm", "ehyb_ell_packed_spmm", 6, 7)
    _raise_on(fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                 packed_vals.data_ptr(), packed_cols.data_ptr(),
                 col_starts.data_ptr(), col_rows.data_ptr(), p, v, l, w, k,
                 kc, threads, _stream(x)), "ehyb_ell_packed_spmm")
    ehyb_ell_packed_spmm.launches += 1
    return y


ehyb_ell_packed_spmm.launches = 0

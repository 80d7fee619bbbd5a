"""Wrappers of the EHYB SpMV kernels (``csrc/ehyb_spmv.cu``).

``ehyb_fused`` replaces ``repro.kernels.ehyb_spmv.ehyb_fused_pallas``
(uniform (V, W) tiles) and ``ehyb_packed_fused`` replaces
``ehyb_packed_fused_pallas`` (packed staircase, the native apply of the
``ehyb_packed`` format).  Both compute y_new = A x_new in the permuted
space, one thread block per partition.  ``ehyb_ell`` and
``ehyb_ell_packed`` replace ``ehyb_ell_pallas`` and
``ehyb_ell_packed_pallas``: the cached (sliced-ELL) part alone, the
guarded apply's unfused level at one right-hand side.  ``er`` replaces
``er_pallas``: the uncached ER rows as per-slot partial sums, which the
caller scatter-adds by ``er_row_idx``.  The CUDA source says what bounds
them and how.

For tensors on the CPU each wrapper runs its plain version
(``kernels.ref``); for CUDA tensors it checks what the kernel takes,
launches it on the current stream, raises on a launch error and adds one to
its ``launches`` count.  It never falls back.

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
from .ref import (ehyb_ell_packed_ref, ehyb_ell_ref, ehyb_fused_ref,
                  ehyb_packed_fused_ref, er_ref)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 1024


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


def _smem_and_threads(device: torch.device, v: int, e: int,
                      itemsize: int, acc_bytes: int = 4) -> int:
    """Threads per block; raises when the (V,) x-slice and the fp32 output
    tile (``acc_bytes`` a row; 0 for the ELL-only kernels, which keep no
    tile) exceed the opt-in shared memory of one block."""
    smem = v * (acc_bytes + itemsize)
    limit = _smem_optin(device.index)
    if smem > limit:
        raise ValueError(f"vec_size {v} needs {smem} bytes of shared memory "
                         f"per block; the card allows {limit}")
    return min(_MAX_THREADS, max(32, -(-max(v, e) // 32) * 32))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def ehyb_fused(x_new: torch.Tensor, ell_vals: torch.Tensor,
               ell_cols: torch.Tensor, er_p_vals: torch.Tensor,
               er_p_cols: torch.Tensor, er_p_rows: torch.Tensor,
               has_er: bool = True) -> torch.Tensor:
    """Fused uniform-tile EHYB SpMV, permuted space: y_new (n_pad[, 1]).

    x_new (n_pad,) or (n_pad, R); ell_vals/ell_cols (P, V, W) with uint16
    local columns; er_p_vals/er_p_cols (P, E, We) with int32 global columns;
    er_p_rows (P, E) int32 local rows."""
    if x_new.device.type == "cpu":
        squeeze = x_new.dim() == 1
        y = ehyb_fused_ref(x_new[:, None] if squeeze else x_new, ell_vals,
                           ell_cols, er_p_vals, er_p_cols, er_p_rows, has_er)
        return y[:, 0] if squeeze else y
    p, v, w = ell_vals.shape
    _, e, we = er_p_vals.shape
    x = _check(x_new, ell_vals, p * v,
               {"ell_cols": torch.uint16, "er_p_cols": torch.int32,
                "er_p_rows": torch.int32, "er_p_vals": ell_vals.dtype},
               [("ell_vals", ell_vals), ("ell_cols", ell_cols),
                ("er_p_vals", er_p_vals), ("er_p_cols", er_p_cols),
                ("er_p_rows", er_p_rows)])
    if ell_cols.shape != ell_vals.shape or er_p_cols.shape != er_p_vals.shape \
            or er_p_rows.shape != (p, e):
        raise ValueError("inconsistent EHYB tile shapes")
    threads = _smem_and_threads(x.device, v, e, x.element_size())
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmv", "ehyb_fused", 7, 7)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
             ell_vals.data_ptr(), ell_cols.data_ptr(), er_p_vals.data_ptr(),
             er_p_cols.data_ptr(), er_p_rows.data_ptr(), p, v, w, e, we,
             int(has_er), threads,
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "ehyb_fused")
    ehyb_fused.launches += 1
    return y if x_new.dim() == 1 else y[:, None]


ehyb_fused.launches = 0


def ehyb_packed_fused(x_new: torch.Tensor, packed_vals: torch.Tensor,
                      packed_cols: torch.Tensor, col_starts: torch.Tensor,
                      col_rows: torch.Tensor, er_p_vals: torch.Tensor,
                      er_p_cols: torch.Tensor, er_p_rows: torch.Tensor, *,
                      vec_size: int, has_er: bool = True) -> torch.Tensor:
    """Fused packed-staircase EHYB SpMV, permuted space: y_new (n_pad[, 1]).

    packed_vals/packed_cols (P, L); col_starts (P, W+1) and col_rows (P, W)
    int32, col_rows non-increasing along W; ER tiles as in
    :func:`ehyb_fused`."""
    if x_new.device.type == "cpu":
        squeeze = x_new.dim() == 1
        y = ehyb_packed_fused_ref(x_new[:, None] if squeeze else x_new,
                                  packed_vals, packed_cols, col_starts,
                                  col_rows, er_p_vals, er_p_cols, er_p_rows,
                                  vec_size, has_er)
        return y[:, 0] if squeeze else y
    p, l = packed_vals.shape
    w = col_rows.shape[1]
    _, e, we = er_p_vals.shape
    x = _check(x_new, packed_vals, p * vec_size,
               {"packed_cols": torch.uint16, "col_starts": torch.int32,
                "col_rows": torch.int32, "er_p_cols": torch.int32,
                "er_p_rows": torch.int32, "er_p_vals": packed_vals.dtype},
               [("packed_vals", packed_vals), ("packed_cols", packed_cols),
                ("col_starts", col_starts), ("col_rows", col_rows),
                ("er_p_vals", er_p_vals), ("er_p_cols", er_p_cols),
                ("er_p_rows", er_p_rows)])
    if packed_cols.shape != (p, l) or col_starts.shape != (p, w + 1) \
            or col_rows.shape != (p, w) or er_p_cols.shape != er_p_vals.shape \
            or er_p_rows.shape != (p, e):
        raise ValueError("inconsistent packed EHYB shapes")
    threads = _smem_and_threads(x.device, vec_size, e, x.element_size())
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmv", "ehyb_packed_fused", 9, 8)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
             packed_vals.data_ptr(), packed_cols.data_ptr(),
             col_starts.data_ptr(), col_rows.data_ptr(), er_p_vals.data_ptr(),
             er_p_cols.data_ptr(), er_p_rows.data_ptr(), p, vec_size, l, w, e,
             we, int(has_er), threads,
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
             ell_cols: torch.Tensor) -> torch.Tensor:
    """Cached (sliced-ELL) part alone on uniform tiles: y_parts of
    x_parts's shape, (P, V) or (P, V, 1).

    ell_vals/ell_cols (P, V, W) with uint16 local columns."""
    if x_parts.device.type == "cpu":
        return _cpu_parts(ehyb_ell_ref, x_parts, ell_vals, ell_cols)
    p, v, w = ell_vals.shape
    x = _one_rhs_parts(x_parts, p, v)
    _check_tables(x, ell_vals, {"ell_cols": torch.uint16},
                  [("ell_vals", ell_vals), ("ell_cols", ell_cols)])
    if ell_cols.shape != ell_vals.shape:
        raise ValueError("inconsistent EHYB tile shapes")
    x = x.contiguous()
    threads = _smem_and_threads(x.device, v, 0, x.element_size(), 0)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmv", "ehyb_ell", 4, 4)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
             ell_vals.data_ptr(), ell_cols.data_ptr(), p, v, w, threads,
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
    _check_tables(x, packed_vals,
                  {"packed_cols": torch.uint16, "col_starts": torch.int32,
                   "col_rows": torch.int32},
                  [("packed_vals", packed_vals), ("packed_cols", packed_cols),
                   ("col_starts", col_starts), ("col_rows", col_rows)])
    if packed_cols.shape != (p, l) or col_starts.shape != (p, w + 1) \
            or col_rows.shape != (p, w):
        raise ValueError("inconsistent packed EHYB shapes")
    x = x.contiguous()
    threads = _smem_and_threads(x.device, v, 0, x.element_size(), 0)
    y = torch.empty_like(x)
    fn = build.entry("ehyb_spmv", "ehyb_ell_packed", 6, 5)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
             packed_vals.data_ptr(), packed_cols.data_ptr(),
             col_starts.data_ptr(), col_rows.data_ptr(), p, v, l, w, threads,
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "ehyb_ell_packed")
    ehyb_ell_packed.launches += 1
    return y.view(x_parts.shape)


ehyb_ell_packed.launches = 0


def er(x_new: torch.Tensor, er_vals: torch.Tensor,
       er_cols: torch.Tensor) -> torch.Tensor:
    """Uncached ER rows -> per-slot partial sums: (Rr,) for x_new (n_pad,),
    (Rr, R) for x_new (n_pad, R), in x's dtype.

    er_vals/er_cols (Rr, W) with int32 global columns (``EHYBDevice.er_*``);
    the caller adds row e's partial into ``y_new[er_row_idx[e]]``."""
    squeeze = x_new.dim() == 1
    x2 = x_new[:, None] if squeeze else x_new
    if x_new.device.type == "cpu":
        y = er_ref(x2, er_vals, er_cols)
        return y[:, 0] if squeeze else y
    if x2.dim() != 2:
        raise ValueError(f"x_new must be (n_pad,) or (n_pad, R), got "
                         f"{tuple(x_new.shape)}")
    _check_tables(x2, er_vals, {"er_cols": torch.int32},
                  [("er_vals", er_vals), ("er_cols", er_cols)])
    if er_vals.dim() != 2 or er_cols.shape != er_vals.shape:
        raise ValueError("er_vals and er_cols must be (Rr, W) alike")
    rr, w = er_vals.shape
    r = x2.shape[1]
    x2 = x2.contiguous()
    out = torch.empty((rr, r), dtype=x2.dtype, device=x2.device)
    fn = build.entry("ehyb_spmv", "er", 4, 3)
    err = fn(_DTYPE_CODE[x2.dtype], x2.data_ptr(), out.data_ptr(),
             er_vals.data_ptr(), er_cols.data_ptr(), rr, w, r,
             torch.cuda.current_stream(x2.device).cuda_stream)
    _raise_on(err, "er")
    er.launches += 1
    return out[:, 0] if squeeze else out


er.launches = 0

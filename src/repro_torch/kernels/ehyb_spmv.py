"""Wrappers of the fused EHYB SpMV kernels (``csrc/ehyb_spmv.cu``).

``ehyb_fused`` replaces ``repro.kernels.ehyb_spmv.ehyb_fused_pallas``
(uniform (V, W) tiles) and ``ehyb_packed_fused`` replaces
``ehyb_packed_fused_pallas`` (packed staircase, the native apply of the
``ehyb_packed`` format).  Both compute y_new = A x_new in the permuted
space, one thread block per partition; the CUDA source says what bounds
them and how.

For tensors on the CPU each wrapper runs its plain version
(``kernels.ref``); for CUDA tensors it checks what the kernel takes,
launches it on the current stream, raises on a launch error and adds one to
its ``launches`` count.  It never falls back.

The kernels take one right-hand side (R = 1), fp32 or bf16 tables with x in
the same dtype, and fp32 accumulation.  A batch (R ≥ 2) waits for the SpMM
kernels and raises ``NotImplementedError``; fp64 raises ``TypeError``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import ehyb_fused_ref, ehyb_packed_fused_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 1024


@functools.cache
def _entry(name: str, n_ptrs: int, n_ints: int):
    """The C entry ``name`` of ``csrc/ehyb_spmv.cu``, typed once: (dtype
    code, n_ptrs pointers, n_ints ints, stream) -> cudaError_t."""
    fn = getattr(build.load("ehyb_spmv"), name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x_new: torch.Tensor, vals: torch.Tensor, n_pad: int,
           dtypes: dict, tables: list) -> torch.Tensor:
    """Validate a CUDA launch; returns x_new as a contiguous (n_pad,) view."""
    from .ops import check_cuda_device

    check_cuda_device(x_new.device)
    if x_new.dim() == 2:
        if x_new.shape[1] != 1:
            raise NotImplementedError(
                f"the CUDA SpMV kernels take one right-hand side; got "
                f"{x_new.shape[1]} (the SpMM kernels are not ported yet)")
        x_new = x_new[:, 0]
    if x_new.shape != (n_pad,):
        raise ValueError(f"x_new has shape {tuple(x_new.shape)}, "
                         f"expected ({n_pad},)")
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA SpMV kernels take float32 or bfloat16 "
                        f"tables, got {vals.dtype}")
    if x_new.dtype != vals.dtype:
        raise TypeError(f"x_new is {x_new.dtype} but the tables are "
                        f"{vals.dtype}")
    for name, t in tables:
        want = dtypes.get(name)
        if want is not None and t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != x_new.device:
            raise ValueError(f"{name} is on {t.device}, x_new on "
                             f"{x_new.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return x_new.contiguous()


@functools.cache
def _smem_optin(index: int) -> int:
    """Opt-in shared memory per block of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _smem_and_threads(device: torch.device, v: int, e: int,
                      itemsize: int) -> int:
    """Threads per block; raises when the (V,) tiles exceed the opt-in
    shared memory of one block."""
    smem = v * (4 + itemsize)
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
    fn = _entry("ehyb_fused", 7, 7)
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
    fn = _entry("ehyb_packed_fused", 9, 8)
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

"""The yardstick of every roofline and ``mfu`` share: one H100's published
peaks and the least time any implementation of the work could take.

A floor counts only what every implementation has to move: each stored
value once at its dtype, x read once and y written once, no index bytes,
and 2 flops a stored value and right-hand side.  The floor is the larger of
the bytes term and the flops term.  Because no index bytes are counted, a
format that compresses its indices cannot push a share past 100 %, and a
change of format leaves the denominator where it is."""

from __future__ import annotations

BANDWIDTH = 3.35e12   # bytes/s, H100 SXM data sheet (at 700 W)
FP32_PEAK = 67e12     # flop/s, H100 SXM fp32 outside the tensor cores
# vector passes of one preconditioned CG iteration besides the apply:
# x, r, p, Ap and the diagonal M⁻¹ read; x, r and p written
CG_VECTOR_PASSES = 8


def apply_bytes(n: int, nnz: int, k: int, itemsize: int) -> int:
    """Bytes of Y = A X with X of k columns: values, X and Y once each."""
    return nnz * itemsize + 2 * n * k * itemsize


def apply_floor_s(n: int, nnz: int, k: int, itemsize: int) -> float:
    """Least seconds of one apply: bytes at the bandwidth or flops at the
    fp32 peak, whichever is larger."""
    return max(apply_bytes(n, nnz, k, itemsize) / BANDWIDTH,
               2 * nnz * k / FP32_PEAK)


def cg_iter_bytes(n: int, nnz: int, itemsize: int) -> int:
    """Bytes of one CG iteration: one apply and the vector passes."""
    return apply_bytes(n, nnz, 1, itemsize) + CG_VECTOR_PASSES * n * itemsize


def cg_iter_floor_s(n: int, nnz: int, itemsize: int) -> float:
    return max(cg_iter_bytes(n, nnz, itemsize) / BANDWIDTH,
               2 * nnz / FP32_PEAK)

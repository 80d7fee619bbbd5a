"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes with plain tensor ops (no
custom kernel, no tricks).  The wrappers run them for tensors on the CPU,
the CPU tests hold them against the JAX package, and ``chip_smoke.py``
holds each kernel against its plain version on the card.  They mirror
``repro.kernels.ref`` (``ehyb_fused_ref``) and add the ELL-only,
packed-staircase and CG-step oracles the JAX package keeps inline.  The
fused and ELL-only versions take any number of right-hand sides, so they
are the plain versions of the SpMV and the SpMM kernels alike.
"""

from __future__ import annotations

import torch

from ..core.spmv import _acc_dtype, _ehyb_ell_part, _fused_er_parts


def ehyb_fused_ref(x_new: torch.Tensor, ell_vals: torch.Tensor,
                   ell_cols: torch.Tensor, er_p_vals: torch.Tensor,
                   er_p_cols: torch.Tensor, er_p_rows: torch.Tensor,
                   has_er: bool = True) -> torch.Tensor:
    """Fused EHYB SpMV oracle: sliced-ELL + per-partition ER, permuted space.

    x_new: (n_pad, R); ell_vals/cols: (P, V, W); er_p_vals/cols: (P, E, We)
    with global column indices; er_p_rows: (P, E) local rows.  Returns
    y_new (n_pad, R) in x's dtype (accumulated in fp32, or fp64)."""
    p, v, _ = ell_vals.shape
    r = x_new.shape[1]
    y = _ehyb_ell_part(ell_vals, ell_cols, x_new.reshape(p, v, r))
    if has_er:
        y = y + _fused_er_parts(x_new, er_p_vals, er_p_cols, er_p_rows, v)
    return y.reshape(-1, r).to(x_new.dtype)


def ehyb_ell_ref(x_parts: torch.Tensor, ell_vals: torch.Tensor,
                 ell_cols: torch.Tensor) -> torch.Tensor:
    """Cached (sliced-ELL) part alone: x_parts (P, V, K) -> y_parts
    (P, V, K) in x's dtype (accumulated in fp32, or fp64) — the oracle of
    the ELL-only SpMM kernel."""
    return _ehyb_ell_part(ell_vals, ell_cols, x_parts).to(x_parts.dtype)


def unpack_staircase(packed_vals: torch.Tensor, packed_cols: torch.Tensor,
                     col_starts: torch.Tensor, col_rows: torch.Tensor,
                     vec_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed staircase -> uniform (P, V, W) tiles (zeros where inactive).

    Cell (p, v, k) is active when ``v < col_rows[p, k]`` and then lives at
    ``col_starts[p, k] + v`` of partition p's packed stream."""
    p, w = col_rows.shape
    v = torch.arange(vec_size, device=col_rows.device)
    active = v[None, :, None] < col_rows[:, None, :]                # (P, V, W)
    idx = col_starts[:, None, :w].to(torch.int64) + v[None, :, None]
    idx = torch.where(active, idx, 0).reshape(p, vec_size * w)
    vals = torch.gather(packed_vals, 1, idx).reshape(p, vec_size, w)
    cols = torch.gather(packed_cols.to(torch.int64), 1, idx).reshape(
        p, vec_size, w)
    return (torch.where(active, vals, 0).to(packed_vals.dtype),
            torch.where(active, cols, 0))


def ehyb_packed_fused_ref(x_new: torch.Tensor, packed_vals: torch.Tensor,
                          packed_cols: torch.Tensor, col_starts: torch.Tensor,
                          col_rows: torch.Tensor, er_p_vals: torch.Tensor,
                          er_p_cols: torch.Tensor, er_p_rows: torch.Tensor,
                          vec_size: int, has_er: bool = True) -> torch.Tensor:
    """Fused packed-staircase EHYB SpMV oracle, permuted space: the
    staircase unpacked to uniform tiles, then :func:`ehyb_fused_ref`."""
    vals, cols = unpack_staircase(packed_vals, packed_cols, col_starts,
                                  col_rows, vec_size)
    return ehyb_fused_ref(x_new, vals, cols, er_p_vals, er_p_cols, er_p_rows,
                          has_er)


def ehyb_ell_packed_ref(x_parts: torch.Tensor, packed_vals: torch.Tensor,
                        packed_cols: torch.Tensor, col_starts: torch.Tensor,
                        col_rows: torch.Tensor) -> torch.Tensor:
    """Cached part alone on the packed staircase: x_parts (P, V, K) ->
    y_parts (P, V, K) — the staircase unpacked, then :func:`ehyb_ell_ref`."""
    vals, cols = unpack_staircase(packed_vals, packed_cols, col_starts,
                                  col_rows, x_parts.shape[1])
    return ehyb_ell_ref(x_parts, vals, cols)


def cg_update_ref(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                  ap: torch.Tensor, minv: torch.Tensor, alpha: torch.Tensor):
    """One CG vector step: returns (x', r', z', <r', z'>, <r', r'>).

    x' = x + alpha·p, r' = r - alpha·ap, z' = minv ⊙ r', computed in fp32
    (fp64 for fp64 vectors) and stored in x's and r's dtypes; the dots are
    0-d tensors in the accumulation dtype."""
    acc = _acc_dtype(r.dtype)
    a = alpha.to(acc)
    xn = x.to(acc) + a * p.to(acc)
    rn = r.to(acc) - a * ap.to(acc)
    zn = minv.to(acc) * rn
    return (xn.to(x.dtype), rn.to(r.dtype), zn.to(r.dtype),
            torch.dot(rn, zn), torch.dot(rn, rn))

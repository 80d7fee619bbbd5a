"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes with plain tensor ops (no
custom kernel, no tricks).  The wrappers run them for tensors on the CPU,
the CPU tests hold them against the JAX package, and ``chip_smoke.py``
holds each kernel against its plain version on the card.  They mirror
``repro.kernels.ref`` (``ehyb_fused_ref``, ``er_ref``) and add the ELL-only,
packed-staircase and CG-step oracles the JAX package keeps inline.  The
fused and ELL-only versions take any number of right-hand sides, so they
are the plain versions of the SpMV and the SpMM kernels alike; the
``*_stream_ref`` forms read the ER part from the compact stream, as the
fused kernels do; :func:`ehyb_ell_ref` and :func:`ehyb_fused_stream_ref`
read each row of the uniform tiles to its live width (``col_rows``), and
:func:`er_live_ref` each ER row's live prefix, as the kernels do.
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


def er_stream_ref(x_new: torch.Tensor, er_s_part_ptr: torch.Tensor,
                  er_s_row_ptr: torch.Tensor, er_s_rows: torch.Tensor,
                  er_s_cols: torch.Tensor, er_s_vals: torch.Tensor,
                  vec_size: int) -> torch.Tensor:
    """ER part from the compact stream (``EHYBDevice.er_s_*``): each live
    entry's value times x at its global column, added with ``index_add_``
    at its row in the permuted space (partition · vec_size + local row).

    x_new (n_pad, R).  Returns (n_pad, R) in the accumulation dtype (fp32,
    or fp64), zero on rows without ER entries."""
    acc = _acc_dtype(x_new.dtype)
    dev = x_new.device
    n_rows = er_s_rows.shape[0]
    parts = torch.repeat_interleave(
        torch.arange(er_s_part_ptr.shape[0] - 1, device=dev),
        er_s_part_ptr.diff().to(torch.int64), output_size=n_rows)
    row_of = parts * vec_size + er_s_rows.to(torch.int64)
    entry_row = torch.repeat_interleave(
        row_of, er_s_row_ptr.diff().to(torch.int64),
        output_size=er_s_cols.shape[0])
    contrib = er_s_vals[:, None].to(acc) * x_new.index_select(
        0, er_s_cols.to(torch.int64)).to(acc)
    y = torch.zeros((x_new.shape[0], x_new.shape[1]), dtype=acc, device=dev)
    return y.index_add_(0, entry_row, contrib)


def ell_live_part(ell_vals: torch.Tensor, ell_cols: torch.Tensor,
                  col_rows: torch.Tensor,
                  x_parts: torch.Tensor) -> torch.Tensor:
    """Cached part on each row's live prefix: slot (p, v, k) of the (P, V,
    W) tiles is read only when ``v < col_rows[p, k]`` (``col_rows``
    non-increasing along W, so the live slots of row v are its first
    width(v) — the number of k with ``col_rows[p, k] > v``).

    x_parts (P, V, R) -> (P, V, R) in the accumulation dtype (fp32, or
    fp64).  With finite x it equals the padded tiles' product (padded slots
    hold value 0 and column 0); with a non-finite ``x_parts[p, 0]`` the
    padded read spreads it into every row of partition p that has a padded
    slot, the live read only into the rows that hold column 0."""
    p, v, w = ell_cols.shape
    r = x_parts.shape[2]
    acc = _acc_dtype(x_parts.dtype)
    live = torch.arange(v, device=col_rows.device)[None, :, None] \
        < col_rows[:, None, :]                                  # (P, V, W)
    idx = torch.where(live, ell_cols.to(torch.int64), 0)
    g = torch.gather(x_parts, 1, idx.reshape(p, v * w, 1).expand(
        p, v * w, r)).reshape(p, v, w, r).to(acc)
    return torch.einsum("pvw,pvwr->pvr",
                        torch.where(live, ell_vals.to(acc), 0),
                        torch.where(live[..., None], g, 0))


def ehyb_fused_stream_ref(x_new: torch.Tensor, ell_vals: torch.Tensor,
                          ell_cols: torch.Tensor, col_rows: torch.Tensor,
                          er_stream: tuple,
                          has_er: bool = True) -> torch.Tensor:
    """Fused EHYB SpMV/SpMM with the ER part from the compact stream — the
    plain version of the fused uniform-tile kernels at any R: the
    sliced-ELL part on each row's live prefix (:func:`ell_live_part`, rows
    per column from ``col_rows`` (P, W)), plus :func:`er_stream_ref` on
    ``er_stream`` (the five ``er_s_*`` tensors in ``core.spmv.ER_STREAM``
    order).  x_new (n_pad, R) -> y_new (n_pad, R) in x's dtype."""
    p, v, _ = ell_vals.shape
    r = x_new.shape[1]
    y = ell_live_part(ell_vals, ell_cols, col_rows, x_new.reshape(p, v, r))
    if has_er:
        y = y + er_stream_ref(x_new, *er_stream, v).reshape(p, v, r)
    return y.reshape(-1, r).to(x_new.dtype)


def ehyb_ell_ref(x_parts: torch.Tensor, ell_vals: torch.Tensor,
                 ell_cols: torch.Tensor,
                 col_rows: torch.Tensor) -> torch.Tensor:
    """Cached (sliced-ELL) part alone, each row read to its live width
    (:func:`ell_live_part`): x_parts (P, V, K) -> y_parts (P, V, K) in x's
    dtype (accumulated in fp32, or fp64) — the oracle of the ELL-only
    kernels."""
    return ell_live_part(ell_vals, ell_cols, col_rows,
                         x_parts).to(x_parts.dtype)


def er_ref(x_new: torch.Tensor, er_vals: torch.Tensor,
           er_cols: torch.Tensor) -> torch.Tensor:
    """Uncached ER part: global gather + row dot — the oracle of the ER
    kernel.

    x_new (n_pad, R); er_vals/er_cols (Rr, W) with int32 global columns.
    Returns (Rr, R) per-ER-slot partial sums in x's dtype (accumulated in
    fp32, or fp64); the caller scatter-adds them by ``er_row_idx``."""
    acc = _acc_dtype(x_new.dtype)
    rr, w = er_cols.shape
    g = x_new.index_select(0, er_cols.reshape(-1).to(torch.int64))
    return torch.einsum("ew,ewr->er", er_vals.to(acc),
                        g.reshape(rr, w, -1).to(acc)).to(x_new.dtype)


def er_widths(er_col_rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(n_rows,) int64 live prefix of each row of the global ER table: the
    number of k with ``er_col_rows[k] > r`` (``er_col_rows`` non-increasing,
    ``EHYBDevice.er_col_rows``)."""
    r = torch.arange(n_rows, device=er_col_rows.device)
    return (er_col_rows[None, :] > r[:, None]).sum(dim=1)


def er_live_ref(x_new: torch.Tensor, er_vals: torch.Tensor,
                er_cols: torch.Tensor,
                er_col_rows: torch.Tensor) -> torch.Tensor:
    """Uncached ER part on each row's live prefix — the plain version of
    the ER kernel, which reads only the entries ``k < width(r)`` of row r
    (:func:`er_widths`) and writes 0 for rows with none.

    x_new (n_pad, R); er_vals/er_cols (Rr, W) with int32 global columns.
    Returns (Rr, R) per-slot partial sums in x's dtype (accumulated in
    fp32, or fp64).  With finite x it equals :func:`er_ref` on the padded
    table (padded slots hold value 0 and column 0); with a non-finite
    ``x[0]`` the padded read spreads it into every padded slot's product,
    the live read does not."""
    acc = _acc_dtype(x_new.dtype)
    rr, w = er_cols.shape
    live = torch.arange(w, device=er_cols.device)[None, :] < er_widths(
        er_col_rows, rr)[:, None]                                # (Rr, W)
    idx = torch.where(live, er_cols.to(torch.int64), 0)
    g = x_new.index_select(0, idx.reshape(-1)).reshape(rr, w, -1).to(acc)
    return torch.einsum("ew,ewr->er",
                        torch.where(live, er_vals.to(acc), 0),
                        torch.where(live[:, :, None], g, 0)).to(x_new.dtype)


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


def ehyb_packed_fused_stream_ref(x_new: torch.Tensor,
                                 packed_vals: torch.Tensor,
                                 packed_cols: torch.Tensor,
                                 col_starts: torch.Tensor,
                                 col_rows: torch.Tensor, er_stream: tuple,
                                 vec_size: int,
                                 has_er: bool = True) -> torch.Tensor:
    """The packed-staircase form of :func:`ehyb_fused_stream_ref`: the
    staircase unpacked to uniform tiles, then the same sums."""
    vals, cols = unpack_staircase(packed_vals, packed_cols, col_starts,
                                  col_rows, vec_size)
    return ehyb_fused_stream_ref(x_new, vals, cols, col_rows, er_stream,
                                 has_er)


def ehyb_ell_packed_ref(x_parts: torch.Tensor, packed_vals: torch.Tensor,
                        packed_cols: torch.Tensor, col_starts: torch.Tensor,
                        col_rows: torch.Tensor) -> torch.Tensor:
    """Cached part alone on the packed staircase: x_parts (P, V, K) ->
    y_parts (P, V, K) — the staircase unpacked, then :func:`ehyb_ell_ref`."""
    vals, cols = unpack_staircase(packed_vals, packed_cols, col_starts,
                                  col_rows, x_parts.shape[1])
    return ehyb_ell_ref(x_parts, vals, cols, col_rows)


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

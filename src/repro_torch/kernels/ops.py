"""Container-level wrappers of the EHYB kernels, as in ``repro.kernels.ops``.

``ehyb_spmv_fused(_permuted)`` apply an :class:`EHYBDevice` through the
uniform-tile kernels and ``ehyb_spmv_packed(_permuted)`` an
:class:`EHYBPackedDevice` through the packed-staircase kernels (the native
apply of the ``ehyb_packed`` format), with the routing of
``repro.kernels.ops``: one right-hand side to the fused SpMV kernels, K ≥ 2
to the fused SpMM kernels; ``use_er_kernel=False`` (the guarded apply's
unfused level), and ER-free operators at K ≥ 2, to the ELL-only kernels
(SpMV at one right-hand side, SpMM at K ≥ 2) plus the plain per-partition
ER part.  The ``*_permuted`` forms take and return permuted-space vectors,
so solver loops skip the per-call pad/``perm``/``inv_perm`` gathers.
:func:`ehyb_ell_only` is the cached part alone, for validation and
benchmarking.

:func:`check_cuda_device` takes the place of the JAX package's
``backend_supports_pallas`` probe: it reads the card's compute capability,
launches nothing and catches nothing, and reads each card's capability once.
"""

from __future__ import annotations

import functools

import torch

from ..core.spmv import (EHYBDevice, EHYBPackedDevice, _as_2d,
                         _from_permuted, _fused_er_parts, _to_permuted)
from . import ehyb_spmm as _km
from . import ehyb_spmv as _k

MIN_CAPABILITY = (9, 0)
# Rhs width from which the wrappers route to the SpMM kernels (the x tile
# staged once for all rhs of a chunk) instead of the SpMV kernels, as
# repro/kernels/ops.py:30 does.
_SPMM_MIN_RHS = 2


def check_cuda_device(device) -> None:
    """Raise unless ``device`` is a CUDA device of compute capability ≥ 9.0
    (Hopper), the target the kernels are compiled for (``sm_90a``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the port's kernels run on CUDA devices, "
                         f"not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    _check_capability(torch.cuda.current_device() if device.index is None
                      else device.index)


@functools.cache
def _check_capability(index: int) -> None:
    """The capability check of card ``index``; a card that passes is
    remembered, one that fails raises on every call."""
    cap = torch.cuda.get_device_capability(index)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a "
            f"(Hopper) and need {MIN_CAPABILITY[0]}.{MIN_CAPABILITY[1]}")


def _unfused(m, x_new: torch.Tensor, ell) -> torch.Tensor:
    """The unfused apply: the ELL-only kernels ``ell(m, x_parts)`` ((P, V, K)
    -> (P, V, K)), then the partition's ER rows added by the plain
    per-partition path.  x_new (n_pad,) or (n_pad, K), result alike."""
    x2, squeeze = _as_2d(x_new)
    k = x2.shape[1]
    y_parts = ell(m, x2.reshape(m.n_parts, m.vec_size, k))
    if m.has_er:
        y_parts = y_parts + _fused_er_parts(
            x2, m.er_p_vals, m.er_p_cols, m.er_p_rows,
            m.vec_size).to(y_parts.dtype)
    y = y_parts.reshape(m.n_pad, k)
    return y[:, 0] if squeeze else y


def _ell_uniform(m: EHYBDevice, x_parts: torch.Tensor) -> torch.Tensor:
    """ELL-only kernel on uniform tiles: SpMV for one column, else SpMM."""
    if x_parts.shape[2] < _SPMM_MIN_RHS:
        return _k.ehyb_ell(x_parts, m.ell_vals, m.ell_cols, m.col_rows)
    return _km.ehyb_ell_spmm(x_parts, m.ell_vals, m.ell_cols, m.col_rows)


def _ell_packed(m: EHYBPackedDevice, x_parts: torch.Tensor) -> torch.Tensor:
    """ELL-only kernel on the packed staircase, routed as
    :func:`_ell_uniform`."""
    ell = _k.ehyb_ell_packed if x_parts.shape[2] < _SPMM_MIN_RHS else \
        _km.ehyb_ell_packed_spmm
    return ell(x_parts, m.packed_vals, m.packed_cols, m.col_starts,
               m.col_rows)


def ehyb_spmv_fused_permuted(m: EHYBDevice, x_new: torch.Tensor, *,
                             use_er_kernel: bool = True) -> torch.Tensor:
    """Permuted-space EHYB SpMV/SpMM on uniform tiles: x_new (n_pad,) or
    (n_pad, K).

    One column goes to the fused SpMV kernel and K ≥ 2 columns to the
    fused SpMM kernel; both read each row of the tiles to its width from
    ``m.col_rows`` and the compact ER stream (``m.er_s_*``, the live ER
    entries only).  With ``use_er_kernel=False`` (the reference's
    unfused level), and for an ER-free operator at K ≥ 2, the ELL-only
    kernel runs and the plain per-partition path adds the ER part from the
    padded ``er_p_*`` tiles."""
    x2 = _as_2d(x_new)[0]
    if not use_er_kernel:
        return _unfused(m, x_new, _ell_uniform)
    if x2.shape[1] < _SPMM_MIN_RHS:
        return _k.ehyb_fused(x_new, m.ell_vals, m.ell_cols, m.col_rows,
                             m.er_stream(), has_er=m.has_er)
    if m.has_er:
        return _km.ehyb_fused_spmm(x2, m.ell_vals, m.ell_cols, m.col_rows,
                                   m.er_stream())
    return _unfused(m, x2, _ell_uniform)


def ehyb_spmv_fused(m: EHYBDevice, x: torch.Tensor,
                    **kw) -> torch.Tensor:
    """Original-space EHYB SpMV/SpMM: permute in, one kernel launch,
    un-permute out.  x: (n,) or (n, K); ``kw`` as for
    :func:`ehyb_spmv_fused_permuted`."""
    x_new, squeeze = _to_permuted(m, x)
    return _from_permuted(m, ehyb_spmv_fused_permuted(m, x_new, **kw),
                          squeeze)


def ehyb_ell_only(m: EHYBDevice, x: torch.Tensor) -> torch.Tensor:
    """The cached (sliced-ELL) part alone, from original-space x (n,) or
    (n, R): y_parts (P, V, R) in the permuted partition layout, as
    ``repro.kernels.ops.ehyb_ell_only_pallas`` returns it (for validation
    and benchmarking)."""
    x_new, _ = _to_permuted(m, x)
    return _ell_uniform(m, x_new.reshape(m.n_parts, m.vec_size,
                                         x_new.shape[1]))


def ehyb_spmv_packed_permuted(m: EHYBPackedDevice, x_new: torch.Tensor, *,
                              use_er_kernel: bool = True) -> torch.Tensor:
    """Permuted-space EHYB SpMV/SpMM on the packed staircase, routed as
    :func:`ehyb_spmv_fused_permuted`: x_new (n_pad,) or (n_pad, K)."""
    x2 = _as_2d(x_new)[0]
    if not use_er_kernel:
        return _unfused(m, x_new, _ell_packed)
    if x2.shape[1] < _SPMM_MIN_RHS:
        return _k.ehyb_packed_fused(x_new, m.packed_vals, m.packed_cols,
                                    m.col_starts, m.col_rows, m.er_stream(),
                                    vec_size=m.vec_size, has_er=m.has_er)
    if m.has_er:
        return _km.ehyb_packed_fused_spmm(
            x2, m.packed_vals, m.packed_cols, m.col_starts, m.col_rows,
            m.er_stream(), vec_size=m.vec_size)
    return _unfused(m, x2, _ell_packed)


def ehyb_spmv_packed(m: EHYBPackedDevice, x: torch.Tensor,
                     **kw) -> torch.Tensor:
    """Original-space packed EHYB SpMV/SpMM.  x: (n,) or (n, K)."""
    x_new, squeeze = _to_permuted(m, x)
    return _from_permuted(m, ehyb_spmv_packed_permuted(m, x_new, **kw),
                          squeeze)

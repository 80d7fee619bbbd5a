"""Container-level wrappers of the EHYB kernels, as in ``repro.kernels.ops``.

``ehyb_spmv_fused(_permuted)`` apply an :class:`EHYBDevice` through the
uniform-tile kernel and ``ehyb_spmv_packed(_permuted)`` an
:class:`EHYBPackedDevice` through the packed-staircase kernel (the native
apply of the ``ehyb_packed`` format).  The ``*_permuted`` forms take and
return permuted-space vectors, so solver loops skip the per-call
pad/``perm``/``inv_perm`` gathers.

:func:`check_cuda_device` takes the place of the JAX package's
``backend_supports_pallas`` probe: it reads the card's compute capability,
launches nothing and catches nothing, and reads each card's capability once.
"""

from __future__ import annotations

import functools

import torch

from ..core.spmv import (EHYBDevice, EHYBPackedDevice, _from_permuted,
                         _to_permuted)
from . import ehyb_spmv as _k

MIN_CAPABILITY = (9, 0)


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


def ehyb_spmv_fused_permuted(m: EHYBDevice,
                             x_new: torch.Tensor) -> torch.Tensor:
    """Permuted-space EHYB SpMV through the uniform-tile kernel:
    x_new (n_pad,) or (n_pad, 1)."""
    return _k.ehyb_fused(x_new, m.ell_vals, m.ell_cols, m.er_p_vals,
                         m.er_p_cols, m.er_p_rows, has_er=m.has_er)


def ehyb_spmv_fused(m: EHYBDevice, x: torch.Tensor) -> torch.Tensor:
    """Original-space EHYB SpMV: permute in, one kernel launch, un-permute
    out.  x: (n,) or (n, 1)."""
    x_new, squeeze = _to_permuted(m, x)
    return _from_permuted(m, ehyb_spmv_fused_permuted(m, x_new), squeeze)


def ehyb_spmv_packed_permuted(m: EHYBPackedDevice,
                              x_new: torch.Tensor) -> torch.Tensor:
    """Permuted-space EHYB SpMV through the packed-staircase kernel:
    x_new (n_pad,) or (n_pad, 1)."""
    return _k.ehyb_packed_fused(x_new, m.packed_vals, m.packed_cols,
                                m.col_starts, m.col_rows, m.er_p_vals,
                                m.er_p_cols, m.er_p_rows,
                                vec_size=m.vec_size, has_er=m.has_er)


def ehyb_spmv_packed(m: EHYBPackedDevice, x: torch.Tensor) -> torch.Tensor:
    """Original-space packed EHYB SpMV.  x: (n,) or (n, 1)."""
    x_new, squeeze = _to_permuted(m, x)
    return _from_permuted(m, ehyb_spmv_packed_permuted(m, x_new), squeeze)

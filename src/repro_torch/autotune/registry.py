"""Format registry: the EHYB formats the port carries, behind one interface.

The subset of ``repro.autotune.registry`` the port needs.  A
:class:`FormatSpec` bundles how to build a format's device container from
the shared host EHYB build, how to fill its value tables with new values
on the same pattern (``refill``, a scatter on the device), its original-
and permuted-space applies, what runs them (``kernel``: ``"cuda"`` for
hand-written kernels, ``"plain"`` for plain PyTorch) and the guarded
apply's unfused level (``fallback``/``fallback_permuted``, None when the
format has none).  As in
the JAX package, the registered apply of ``ehyb`` is the plain path
(``core.spmv``; its chain is native → reference) and the apply of
``ehyb_packed`` is the packed-staircase kernel (``kernels.ops``), with
``use_er_kernel=False`` as its unfused level.  The other five formats wait
for the autotuner's port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from ..core.ehyb import EHYB, pack_staircase
from ..core.spmv import (EHYBDevice, EHYBPackedDevice, ehyb_spmv,
                         ehyb_spmv_permuted, scatter_values)
from ..kernels.ops import ehyb_spmv_packed, ehyb_spmv_packed_permuted


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    name: str
    build: Callable      # (host EHYB, dtype, device) -> device container
    apply: Callable      # (obj, x) -> y, original space
    permuted: Callable   # (obj, x_new) -> y_new, permuted space
    kernel: str = "plain"              # "cuda": the applies launch kernels
    # (structure, vals, index) -> obj: the per-nnz values ``vals`` (CSR
    # order, on the device, in the table dtype) scattered into new value
    # tables through the plan's pattern-only ``index``, every structural
    # tensor shared with ``structure`` (``core.spmv.scatter_values``)
    refill: Optional[Callable] = None
    fallback: Optional[Callable] = None            # unfused level, original
    fallback_permuted: Optional[Callable] = None   # unfused level, permuted
    description: str = ""


FORMATS: Dict[str, FormatSpec] = {}


def register_format(spec: FormatSpec) -> FormatSpec:
    if spec.name in FORMATS:
        raise ValueError(f"format {spec.name!r} already registered")
    FORMATS[spec.name] = spec
    return spec


def get_format(name: str) -> FormatSpec:
    try:
        return FORMATS[name]
    except KeyError:
        raise KeyError(f"unknown SpMV format {name!r}; "
                       f"registered: {sorted(FORMATS)}") from None


def shared_packed(e: EHYB):
    """Packed-staircase view of a host EHYB build, memoized on it."""
    pk = getattr(e, "_packed", None)
    if pk is None:
        pk = e._packed = pack_staircase(e)
    return pk


def _build_ehyb(e: EHYB, dtype, device) -> EHYBDevice:
    return EHYBDevice.from_ehyb(e, dtype, device=device)


def _build_ehyb_packed(e: EHYB, dtype, device) -> EHYBPackedDevice:
    return EHYBPackedDevice.from_packed(shared_packed(e), dtype,
                                        device=device)


def _packed_unfused(d, x):
    return ehyb_spmv_packed(d, x, use_er_kernel=False)


def _packed_unfused_permuted(d, x_new):
    return ehyb_spmv_packed_permuted(d, x_new, use_er_kernel=False)


register_format(FormatSpec(
    "ehyb", _build_ehyb, ehyb_spmv, ehyb_spmv_permuted,
    refill=scatter_values,
    description="EHYB uniform tiles, uint16 local cols; plain PyTorch "
                "apply"))
register_format(FormatSpec(
    "ehyb_packed", _build_ehyb_packed, ehyb_spmv_packed,
    ehyb_spmv_packed_permuted, kernel="cuda", refill=scatter_values,
    fallback=_packed_unfused,
    fallback_permuted=_packed_unfused_permuted,
    description="EHYB packed staircase; fused CUDA kernel on the card"))

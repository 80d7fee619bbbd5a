"""Format registry: the EHYB formats the port carries, behind one interface.

The subset of ``repro.autotune.registry`` this slice needs.  A
:class:`FormatSpec` bundles how to build a format's device container from
the shared host EHYB build and its original- and permuted-space applies.
As in the JAX package, the registered apply of ``ehyb`` is the plain path
(``core.spmv``) and the apply of ``ehyb_packed`` is the packed-staircase
kernel (``kernels.ops``).  The other five formats wait for the autotuner's
port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from ..core.ehyb import EHYB, pack_staircase
from ..core.spmv import (EHYBDevice, EHYBPackedDevice, ehyb_spmv,
                         ehyb_spmv_permuted)
from ..kernels.ops import ehyb_spmv_packed, ehyb_spmv_packed_permuted


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    name: str
    build: Callable      # (host EHYB, dtype, device) -> device container
    apply: Callable      # (obj, x) -> y, original space
    permuted: Callable   # (obj, x_new) -> y_new, permuted space
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


register_format(FormatSpec(
    "ehyb", _build_ehyb, ehyb_spmv, ehyb_spmv_permuted,
    "EHYB uniform tiles, uint16 local cols; plain PyTorch apply"))
register_format(FormatSpec(
    "ehyb_packed", _build_ehyb_packed, ehyb_spmv_packed,
    ehyb_spmv_packed_permuted,
    "EHYB packed staircase; fused CUDA kernel on the card"))

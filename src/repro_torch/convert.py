"""Carry state across from the JAX package into the port.

The JAX package's device containers (``repro.core.spmv.EHYBDevice`` and
``EHYBPackedDevice``) are pytrees of arrays; their leaves, as a dict of
numpy arrays (``{field: np.asarray(getattr(obj, field))}``), plus the static
fields (``n``, ``n_pad``, ``n_parts``, ``vec_size``, ``has_er``) become the
port's container of the same name on a given device — so both packages can
compute on identical tables.  As everywhere in the port, the device defaults
to ``cuda`` and raises without a card; pass ``device="cpu"`` for the plain
CPU paths.  This module reads numpy arrays only; it imports nothing of the
JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api.plan import resolve_device
from .core.matrices import SparseCSR
from .core.spmv import EHYBDevice, EHYBPackedDevice

_CONTAINERS = {"EHYBDevice": EHYBDevice, "EHYBPackedDevice": EHYBPackedDevice}
_STATIC = ("n", "n_pad", "n_parts", "vec_size", "has_er")
_INDEX_FIELDS = ("perm", "inv_perm")   # int64 in the port (JAX keeps int32)


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy -> tensor on ``device`` (default ``cuda``), including ml_dtypes'
    bfloat16 (bit-exact)."""
    device = resolve_device(device)
    a = np.array(a)      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def device_container(kind: str, leaves: dict, static: dict, device=None):
    """The port's ``kind`` container (``"EHYBDevice"`` or
    ``"EHYBPackedDevice"``) on ``device`` (default ``cuda``) from the JAX
    container's leaves and static fields; leaves the port does not carry
    are ignored."""
    device = resolve_device(device)
    cls = _CONTAINERS[kind]
    kw = {k: static[k] for k in _STATIC}
    for f in dataclasses.fields(cls):
        if f.name in _STATIC:
            continue
        t = tensor_from_numpy(leaves[f.name], device)
        kw[f.name] = t.to(torch.int64) if f.name in _INDEX_FIELDS else t
    kw["has_er"] = bool(kw["has_er"])
    return cls(**kw)


def csr_from_arrays(n: int, indptr, indices, data) -> SparseCSR:
    """A port :class:`SparseCSR` from the JAX package's CSR arrays."""
    return SparseCSR(n=int(n), indptr=np.asarray(indptr, dtype=np.int64),
                     indices=np.asarray(indices, dtype=np.int32),
                     data=np.asarray(data, dtype=np.float64))

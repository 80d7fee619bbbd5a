"""Carry state across from the JAX package into the port.

The JAX package's device containers (``repro.core.spmv.EHYBDevice`` and
``EHYBPackedDevice``) are pytrees of arrays; their leaves, as a dict of
numpy arrays (``{field: np.asarray(getattr(obj, field))}``), plus the static
fields (``n``, ``n_pad``, ``n_parts``, ``vec_size``, ``has_er``) become the
port's container of the same name on a given device — so both packages can
compute on identical tables.  :func:`sparse_linear` carries a pruned layer
(``repro.core.sparse_linear.SparseLinear``) across the same way.  As
everywhere in the port, the device defaults to ``cuda`` and raises without
a card; pass ``device="cpu"`` for the plain CPU paths.  This module reads
numpy arrays only; it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api.plan import resolve_device
from .core.matrices import SparseCSR
from .core.spmv import EHYBDevice, EHYBPackedDevice

_CONTAINERS = {"EHYBDevice": EHYBDevice, "EHYBPackedDevice": EHYBPackedDevice}
_FORMATS = {"EHYBDevice": "ehyb", "EHYBPackedDevice": "ehyb_packed"}
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


def sparse_linear(kind: str, leaves: dict, static: dict, *, csr, d_in: int,
                  d_out: int, density: float, partition_method: str,
                  k: int = 1, device=None, cls=None):
    """The port's :class:`~repro_torch.core.sparse_linear.SparseLinear` on
    the JAX layer's own device tables (bf16 bit for bit).

    ``kind``/``leaves``/``static`` are the JAX layer's ``op.obj`` as for
    :func:`device_container`; ``csr`` is its host CSR (anything with ``n``,
    ``indptr``, ``indices`` and ``data``), and ``partition_method`` the
    strategy it was planned with.  The port plans the same pattern on
    ``device`` and raises unless that plan lays the matrix out as the
    tables do (the same permutation)."""
    from .api.config import ExecutionConfig
    from .api.operator import LinearOperator
    from .api.plan import plan
    from .core.sparse_linear import SparseLinear, _host_ehyb_of

    obj = device_container(kind, leaves, static, device)
    m = csr_from_arrays(csr.n, csr.indptr, csr.indices, csr.data)
    p = plan(m, execution=ExecutionConfig(
        format=_FORMATS[kind], partition_method=partition_method, k=k),
        device=obj.perm.device)
    op = LinearOperator(plan=p, obj=obj, dtype=obj.er_p_vals.dtype, csr=m)
    e = _host_ehyb_of(op)
    if not np.array_equal(e.perm, obj.perm.cpu().numpy()):
        raise ValueError(f"the layer's tables were laid out by another "
                         f"partition than the port's {p!r} on "
                         f"{obj.perm.device}")
    return (cls or SparseLinear)(d_in=d_in, d_out=d_out, op=op,
                                 density=density, csr=m, ehyb=e)

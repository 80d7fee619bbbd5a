"""Carry state across from the JAX package into the port.

The JAX package's device containers (``repro.core.spmv.COODevice``,
``ELLDevice``, ``HYBDevice``, ``EHYBDevice``, ``EHYBBucketsDevice``,
``EHYBPackedDevice``, and the dense format's bare array as
``"DenseDevice"``) are pytrees of arrays; their leaves, as a dict of numpy
arrays (``{field: np.asarray(getattr(obj, field))}``; the bucketed
container's per-bucket tuples as sequences of arrays), plus the static
fields (``n``, and for the EHYB family ``n_pad``, ``n_parts``,
``vec_size``, ``has_er``, the bucketed ``widths``) become the port's
container of the same name on a given device — so both packages can
compute on identical tables.  :func:`sparse_linear` carries a pruned layer
(``repro.core.sparse_linear.SparseLinear``) across the same way.  As
everywhere in the port, the device defaults to ``cuda`` and raises without
a card; pass ``device="cpu"`` for the plain CPU paths.
:func:`solve_policy` carries a ``repro.reliability.SolvePolicy`` across
field by field, so both packages' escalation ladders can run under one
policy.  This module reads numpy arrays and attributes only; it imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api.plan import resolve_device
from .core.matrices import SparseCSR
from .core.spmv import (ER_STREAM, COODevice, DenseDevice,
                        EHYBBucketsDevice, EHYBDevice, EHYBPackedDevice,
                        ELLDevice, HYBDevice, column_rows, er_column_rows,
                        er_stream_tensors)
from .reliability.policy import SolvePolicy

_CONTAINERS = {"COODevice": COODevice, "ELLDevice": ELLDevice,
               "HYBDevice": HYBDevice, "EHYBDevice": EHYBDevice,
               "EHYBBucketsDevice": EHYBBucketsDevice,
               "EHYBPackedDevice": EHYBPackedDevice,
               "DenseDevice": DenseDevice}
_FORMATS = {"COODevice": "csr", "ELLDevice": "ell", "HYBDevice": "hyb",
            "EHYBDevice": "ehyb", "EHYBBucketsDevice": "ehyb_bucketed",
            "EHYBPackedDevice": "ehyb_packed", "DenseDevice": "dense"}
_STATIC = ("n", "n_pad", "n_parts", "vec_size", "has_er")
_INDEX_FIELDS = ("perm", "inv_perm")   # int64 in the port (JAX keeps int32)
# the port's own fields of each container, laid out from the pattern (the
# packed container's col_rows is the staircase's, a leaf)
_LAID_OUT = {EHYBDevice: ER_STREAM + ("col_rows", "er_col_rows"),
             EHYBPackedDevice: ER_STREAM + ("er_col_rows",)}


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy -> tensor on ``device`` (default ``cuda``), including ml_dtypes'
    bfloat16 (bit-exact)."""
    device = resolve_device(device)
    a = np.array(a)      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _plain_container(cls, leaves: dict, static: dict, device):
    """A container of the formats without the compact ER stream, field by
    field (the bucketed one's per-bucket tuples: int64 partition ids,
    columns as they are, the value tiles flattened into one table)."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in static:
            kw[f.name] = static[f.name]
        elif f.name == "part_ids":
            kw[f.name] = tuple(tensor_from_numpy(p, device).to(torch.int64)
                               for p in leaves[f.name])
        elif f.name == "cols" and cls is EHYBBucketsDevice:
            kw[f.name] = tuple(tensor_from_numpy(c, device)
                               for c in leaves[f.name])
        elif f.name == "vals" and cls is EHYBBucketsDevice:
            kw[f.name] = torch.cat([tensor_from_numpy(v, device).reshape(-1)
                                    for v in leaves[f.name]])
        else:
            t = tensor_from_numpy(leaves[f.name], device)
            kw[f.name] = t.to(torch.int64) if f.name in _INDEX_FIELDS else t
    if "has_er" in kw:
        kw["has_er"] = bool(kw["has_er"])
    if "widths" in kw:
        kw["widths"] = tuple(int(w) for w in kw["widths"])
    return cls(**kw)


def device_container(kind: str, leaves: dict, static: dict, device=None, *,
                     host=None):
    """The port's ``kind`` container (a key of ``_CONTAINERS``: the JAX
    container's class name, ``"DenseDevice"`` for the dense format's
    array as ``{"vals": a}``) on ``device`` (default ``cuda``) from the JAX
    container's leaves and static fields; leaves the port does not carry
    are ignored.

    For ``"EHYBDevice"`` and ``"EHYBPackedDevice"``, ``host`` is required:
    the host EHYB build the leaves came from (the JAX package's or the
    port's).  The port's own fields — the compact ER stream ``er_s_*``,
    ``er_col_rows`` and the uniform container's ``col_rows`` — are laid out
    from its pattern, which the leaves do not hold.  Raises ``ValueError``
    without ``host``, or when ``host`` lays the matrix out otherwise than
    the leaves (another permutation, another ER table or another ER
    grouping).  The packed container's tuned ``rhs_chunk`` is
    ``static.get("rhs_chunk")``."""
    device = resolve_device(device)
    cls = _CONTAINERS[kind]
    if cls not in _LAID_OUT:
        return _plain_container(cls, leaves, static, device)
    if host is None:
        raise ValueError("device_container needs host=, the host EHYB build "
                         "the leaves came from: the compact ER stream and "
                         "col_rows are laid out from its pattern")
    if not np.array_equal(np.asarray(host.perm),
                          np.asarray(leaves["perm"])):
        raise ValueError("host= was partitioned otherwise than the leaves "
                         "(another permutation)")
    if tuple(np.shape(leaves["er_vals"])) != (host.er_rows, host.er_width):
        raise ValueError(f"the ER table is {np.shape(leaves['er_vals'])}; "
                         f"host= lays it out as "
                         f"{(host.er_rows, host.er_width)}")
    kw = {k: static[k] for k in _STATIC}
    for f in dataclasses.fields(cls):
        if f.name in _STATIC or f.name in _LAID_OUT[cls]:
            continue
        if f.name == "rhs_chunk":
            kw[f.name] = static.get("rhs_chunk")
            continue
        t = tensor_from_numpy(leaves[f.name], device)
        kw[f.name] = t.to(torch.int64) if f.name in _INDEX_FIELDS else t
    kw["has_er"] = bool(kw["has_er"])
    kw.update(er_stream_tensors(host, kw["er_p_vals"], kw["er_p_cols"]))
    kw["er_col_rows"] = torch.from_numpy(er_column_rows(host)).to(device)
    if cls is EHYBDevice:
        kw["col_rows"] = torch.from_numpy(column_rows(host)).to(device)
    return cls(**kw)


def solve_policy(p) -> SolvePolicy:
    """The port's :class:`SolvePolicy` with the fields of ``p`` (a JAX
    ``SolvePolicy``, or anything with the same attribute names)."""
    return SolvePolicy(**{f.name: getattr(p, f.name)
                          for f in dataclasses.fields(SolvePolicy)})


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
    tables do (the same permutation, :func:`device_container`)."""
    from .api.config import ExecutionConfig
    from .api.operator import LinearOperator
    from .api.plan import plan
    from .core.sparse_linear import SparseLinear

    device = resolve_device(device)
    m = csr_from_arrays(csr.n, csr.indptr, csr.indices, csr.data)
    p = plan(m, execution=ExecutionConfig(
        format=_FORMATS[kind], partition_method=partition_method, k=k),
        device=device)
    e = p.host_build(m) if _CONTAINERS[kind] in _LAID_OUT else None
    obj = device_container(kind, leaves, static, device, host=e)
    op = LinearOperator(plan=p, obj=obj, dtype=obj.value_tables()[0].dtype,
                        _csr=m)
    return (cls or SparseLinear)(d_in=d_in, d_out=d_out, op=op,
                                 density=density, csr=m, ehyb=e)

"""Operator API: neural-network integration (pruned sparse layers).

The port of ``repro.api.nn``.  :func:`pruned_linear` magnitude-prunes a
dense weight matrix, plans its pattern, binds the surviving weights and
wraps the :class:`~repro_torch.api.LinearOperator` as a
:class:`~repro_torch.core.sparse_linear.SparseLinear` layer, whose forward
over T tokens is one batched apply of T right-hand sides.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.sparse_linear import SparseLinear, _host_ehyb_of, prune_to_csr
from .config import ExecutionConfig
from .plan import plan as _plan


def pruned_linear(w, density: float = 0.1, *, format: str = "auto",
                  dtype=None, partition_method: Optional[str] = None,
                  mode: str = "model", candidates=None, k: int = 1,
                  cls=None, mesh=None, device=None):
    """Prune ``w`` (dense ``(d_out, d_in)``) and bind it as a sparse layer.

    The format and the partition strategy are autotuned by default, as in
    :func:`~repro_torch.api.plan`.  ``k`` declares the expected activation
    batch width (tokens per apply): the format is ranked at that SpMM width,
    and on the card the plan sizes its partitions so a block holds that
    many rhs columns (up to 16).  ``device`` defaults to ``cuda``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a mesh shards the layer over several devices; the distributed "
            "path is not ported yet (ROADMAP Queue 1 item 8)")
    cls = cls or SparseLinear
    d_out, d_in = w.shape
    csr = prune_to_csr(w, density)
    execution = ExecutionConfig(
        format=format, mode=mode, partition_method=partition_method,
        candidates=None if candidates is None else tuple(candidates), k=k)
    op = _plan(csr, execution=execution, device=device).bind(
        csr, dtype=dtype or torch.float32)
    return cls(d_in=d_in, d_out=d_out, op=op, density=density, csr=csr,
               ehyb=_host_ehyb_of(op))

"""Operator API: the pattern-only :class:`Plan` and its cache.

The port of ``repro.api.plan`` for this slice.  The paper's economic
argument (§3, §4.3) is that EHYB preprocessing is paid once per sparsity
pattern and amortized across many SpMVs:

    p  = plan(A, execution=ExecutionConfig(format="ehyb_packed",
                                           partition_method="bfs"))
    op = p.bind(A)                # values -> LinearOperator (device tables)
    y  = op @ x                   # apply
    r  = op.solve(b, precond="spai")

A plan fixes the format, the device, the cache sizing and the partition;
``bind`` builds the host EHYB tables for one set of values on that
partition (memoized by a value-inclusive hash) and uploads them.  Plans are
memoized in a :class:`PlanCache` keyed by the pattern hash.

Every apply of a bound operator goes through the plan's guard
(``reliability.guard``): ``_raw_apply()``/``_raw_apply_permuted()`` hand
out one guard per kind, which resolves the level of the format's fallback
chain that runs and reports any downgrade in :attr:`Plan.degraded`.

Every entry point takes ``device=``; the default is ``cuda``, and without a
card it raises rather than carrying on on the CPU.  On the CPU the plan
keeps the reference's cache-sizing constants, so its builds are
bit-identical to the JAX package's; on the card it sizes the partitions
with the card's own shared memory and SM count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..autotune.cost import matrix_key, pattern_hash
from ..autotune.registry import get_format, shared_packed
from ..core.cache import BoundedCache
from ..core.ehyb import EHYB, build_ehyb
from ..core.matrices import SparseCSR
from ..core.spmv import EHYBPackedDevice, value_index
from ..core.partition import (Partition, choose_vec_size,
                              choose_vec_size_cuda, get_strategy,
                              make_partition)
from ..kernels.ehyb_spmm import SPMM_RHS_CHUNK
from .config import ExecutionConfig

# The partition is sized for fp32 tables whatever the bind dtype, so one
# plan serves every dtype its kernels take (as the reference sizes with 4).
_SIZING_BYTES = 4


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device (default ``cuda``); raises for a CUDA
    device the kernels cannot run on, and for any other device type."""
    from ..kernels.ops import check_cuda_device

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        check_cuda_device(device)
    elif device.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device}")
    return device


def partition_sizing(n: int, device: torch.device,
                     k: int = 1) -> tuple[int, int]:
    """(n_parts, vec_size) for an ``n``-row pattern planned on ``device``
    for applies of ``k`` right-hand sides.

    On the card a block must hold ``min(k, SPMM_RHS_CHUNK)`` rhs columns of
    its x-slice and output tile (the SpMM kernels sweep wider batches in
    chunks of that width); on the CPU the reference's constants hold
    whatever ``k`` is."""
    if device.type == "cpu":
        return choose_vec_size(n, _SIZING_BYTES)
    props = torch.cuda.get_device_properties(device)
    return choose_vec_size_cuda(n, _SIZING_BYTES,
                                props.shared_memory_per_block_optin,
                                props.multi_processor_count,
                                rhs=min(k, SPMM_RHS_CHUNK))


class PlanCache:
    """Bounded LRU of :class:`Plan` objects keyed by (pattern hash,
    execution token, device), plus the pattern-only partitions and the host
    EHYB builds the plans of one pattern share."""

    def __init__(self, maxsize: int = 32):
        self._plans = BoundedCache(maxsize=maxsize)
        self._parts = BoundedCache(maxsize=maxsize)
        self._host = BoundedCache(maxsize=maxsize)

    def plan_for(self, pattern: SparseCSR, execution: ExecutionConfig,
                 device: torch.device) -> "Plan":
        key = pattern_hash(pattern)
        ck = (key, execution.token(), str(device))
        p = self._plans.get(ck)
        if p is None:
            p = Plan._create(pattern, key, execution, device, self)
            self._plans[ck] = p
        return p

    def partition(self, pattern: SparseCSR, key: str, method: str,
                  n_parts: int, vec_size: int) -> Partition:
        pk = (key, method, n_parts, vec_size)
        part = self._parts.get(pk)
        if part is None:
            part = self._parts[pk] = make_partition(
                pattern, method=method, n_parts=n_parts, vec_size=vec_size)
        return part

    def host_ehyb(self, m: SparseCSR, key: str, part: Partition) -> EHYB:
        """Host EHYB build of ``m`` on ``part``, memoized by a
        value-inclusive hash (rebinding the same values builds nothing)."""
        hk = (matrix_key(m, key), part.method, part.n_parts, part.vec_size)
        e = self._host.get(hk)
        if e is None:
            e = self._host[hk] = build_ehyb(m, part=part)
        return e


PLAN_CACHE = PlanCache()


def plan(pattern: SparseCSR, *, execution: Optional[ExecutionConfig] = None,
         device=None, cache: Optional[PlanCache] = None) -> "Plan":
    """Plan the operator lifecycle for a sparsity pattern on ``device``.

    ``pattern`` is a :class:`SparseCSR`; only its ``indptr``/``indices``
    determine the plan.  ``device`` defaults to ``cuda`` and raises without
    a Hopper card; pass ``device="cpu"`` for the plain CPU paths.
    """
    if not isinstance(pattern, SparseCSR):
        raise TypeError(f"plan() takes a SparseCSR pattern, "
                        f"got {type(pattern).__name__}")
    execution = execution or ExecutionConfig()
    if execution.format == "auto":
        raise NotImplementedError(
            "format='auto' needs the format autotuner, which is not ported "
            "yet (ROADMAP Queue 1 item 5); pin format='ehyb_packed' or "
            "'ehyb'")
    if execution.partition_method is None:
        raise NotImplementedError(
            "partition_method=None autotunes the partition strategy, which "
            "is not ported yet (ROADMAP Queue 1 item 5); pin one, e.g. "
            "partition_method='bfs'")
    get_format(execution.format)
    get_strategy(execution.partition_method)
    device = resolve_device(device)
    return (cache or PLAN_CACHE).plan_for(pattern, execution, device)


@dataclasses.dataclass(eq=False)
class Plan:
    """Pattern-only execution plan: format, device, partition — everything
    cacheable per sparsity pattern."""

    key: str                        # sparsity-pattern hash
    n: int
    nnz: int
    format: str
    execution: ExecutionConfig
    device: torch.device
    partition: Partition
    pattern: SparseCSR
    cache: PlanCache
    _indices_ok: Optional[bool] = None    # bind-time index check, memoized
    _guards: dict = dataclasses.field(default_factory=dict)  # kind -> guard
    _layout: Optional[EHYB] = None   # a host build (pattern-only scatters)
    _coo: Optional[Tuple[np.ndarray, np.ndarray]] = None
    _coo_t: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    _value_idx: Optional[torch.Tensor] = None

    @classmethod
    def _create(cls, pattern: SparseCSR, key: str,
                execution: ExecutionConfig, device: torch.device,
                cache: PlanCache) -> "Plan":
        n_parts, vec_size = partition_sizing(pattern.n, device, execution.k)
        part = cache.partition(pattern, key, execution.partition_method,
                               n_parts, vec_size)
        return cls(key=key, n=pattern.n, nnz=pattern.nnz,
                   format=execution.format, execution=execution,
                   device=device, partition=part, pattern=pattern,
                   cache=cache)

    @property
    def partition_strategy(self) -> str:
        return self.partition.method

    @property
    def n_parts(self) -> int:
        return self.partition.n_parts

    @property
    def vec_size(self) -> int:
        return self.partition.vec_size

    # ---- binding -----------------------------------------------------------

    def _as_csr(self, values) -> SparseCSR:
        """Normalize bind input to a SparseCSR on this plan's pattern."""
        if isinstance(values, SparseCSR):
            if values.n != self.n or values.nnz != self.nnz or \
                    pattern_hash(values) != self.key:
                raise ValueError(
                    "bind() needs values on this plan's sparsity pattern; "
                    "call repro_torch.api.plan() for a new pattern")
            return values
        data = np.asarray(values, dtype=np.float64)
        if data.shape != (self.nnz,):
            raise ValueError(f"bind() takes a ({self.nnz},) per-nnz value "
                             f"array (CSR order) or a SparseCSR; "
                             f"got shape {data.shape}")
        return SparseCSR(self.n, self.pattern.indptr, self.pattern.indices,
                         data)

    def _validate_bind(self, data: np.ndarray) -> None:
        """Reject non-finite values and out-of-range column indices at the
        boundary: both corrupt every downstream apply silently (an index
        past the end makes a kernel read out of bounds)."""
        bad = int((~np.isfinite(data)).sum())
        if bad:
            raise ValueError(f"bind() got {bad} non-finite value(s)")
        if self._indices_ok is None:
            idx = np.asarray(self.pattern.indices)
            self._indices_ok = bool(
                idx.size == 0 or (idx.min() >= 0 and idx.max() < self.n))
        if not self._indices_ok:
            raise ValueError(f"plan pattern carries column indices outside "
                             f"[0, {self.n})")

    def host_build(self, values) -> EHYB:
        """The host EHYB build of ``values`` on this plan's partition."""
        return self.cache.host_ehyb(self._as_csr(values), self.key,
                                    self.partition)

    def bind(self, values, *, dtype=None, validate: bool = True):
        """Bind entry values to the planned structure -> LinearOperator.

        ``values`` is a :class:`SparseCSR` on this plan's pattern or a
        ``(nnz,)`` per-nnz array in CSR order; ``dtype`` is the table dtype
        (default: the plan's, else float32)."""
        from .operator import LinearOperator

        dtype = dtype or self.execution.dtype or torch.float32
        csr = self._as_csr(values)
        if validate:
            self._validate_bind(csr.data)
        e = self.cache.host_ehyb(csr, self.key, self.partition)
        if self._layout is None:
            self._layout = e
        obj = get_format(self.format).build(e, dtype, self.device)
        return LinearOperator(plan=self, obj=obj, dtype=dtype, csr=csr)

    # ---- guarded applies ---------------------------------------------------

    def _raw_apply(self):
        """The format's original-space ``(obj, x) -> y`` apply, wrapped in
        the reliability guard: a kernel that fails to build or launch
        downgrades through the fallback chain (fused -> unfused ->
        reference) instead of crashing the apply."""
        from ..reliability.guard import guarded_apply

        return guarded_apply(self, "apply")

    def _raw_apply_permuted(self):
        """The guarded permuted-space apply (the solver's matvec)."""
        from ..reliability.guard import guarded_apply

        return guarded_apply(self, "permuted")

    @property
    def degraded(self) -> dict:
        """Non-primary guard resolutions, ``{kind: level_name}`` — empty
        when every apply runs its native level (or none resolved yet)."""
        return {kind: g.level for kind, g in self._guards.items()
                if g.level is not None and g.chain and g.level != g.chain[0]}

    # ---- pattern and values ------------------------------------------------

    def coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-nnz (rows, cols) of the pattern in CSR order (host int64)."""
        if self._coo is None:
            rows = np.repeat(np.arange(self.n, dtype=np.int64),
                             self.pattern.row_lengths())
            self._coo = (rows, self.pattern.indices.astype(np.int64))
        return self._coo

    def coo_tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`coo` as int64 tensors on the plan's device (memoized)."""
        if self._coo_t is None:
            self._coo_t = tuple(torch.from_numpy(a).to(self.device)
                                for a in self.coo())
        return self._coo_t

    def values_of(self, obj) -> torch.Tensor:
        """The per-nnz values in CSR order, read on the device from the
        container ``obj`` bound on this plan (each value once, from the
        tables its apply reads), in the container's value dtype.

        The port's counterpart of the JAX package's probed value maps: the
        positions come from the host build's own scatters
        (``core.spmv.value_index``), which depend on the pattern alone, so
        they hold for every bind of the plan."""
        if self._value_idx is None:
            e = self._layout or self.host_build(self.pattern)
            pk = shared_packed(e) if isinstance(obj, EHYBPackedDevice) \
                else None
            self._value_idx = torch.from_numpy(value_index(e, pk)).to(
                self.device)
        flat = torch.cat([t.reshape(-1) for t in obj.value_tables()])
        return flat.index_select(0, self._value_idx)

    def __repr__(self):
        return (f"Plan(n={self.n}, nnz={self.nnz}, format={self.format!r}, "
                f"partition={self.partition_strategy!r}, "
                f"n_parts={self.n_parts}, vec_size={self.vec_size}, "
                f"device={self.device}, key={self.key})")

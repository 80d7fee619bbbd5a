"""Operator API: the pattern-only :class:`Plan` and its cache.

The port of ``repro.api.plan`` (without the mesh and the persistent store).
The paper's economic argument (§3, §4.3) is that EHYB preprocessing is paid
once per sparsity pattern and amortized across many SpMVs:

    p  = plan(A)                  # pattern-only: partition strategy and
                                  # format autotuned, cache sizing
    op = p.bind(A)                # values -> LinearOperator (device tables)
    y  = op @ x                   # apply
    r  = op.solve(b, precond="spai")

A plan fixes the format, the device, the cache sizing and the partition.
With the default :class:`ExecutionConfig` (``format="auto"``,
``partition_method=None``) it decides them as the reference does: every
partition strategy priced at the plan's geometry (``autotune_partition``),
then every format ranked by modeled bytes (``autotune``), and keeps both
tables (:attr:`Plan.partition_tuning`, :attr:`Plan.tuning`) and the
resolved tunable parameters (:attr:`Plan.tuned`).  The first ``bind`` of
an EHYB-family plan builds the host EHYB tables on the partition and
uploads them; the first bind of any other format builds its structure and
scatters the values into it, as every rebind does.  Every later bind of
the plan (``op.update_values``, another dtype) is a refill: the per-nnz
values are uploaded once and scattered into new value tables on the
device through a pattern-only index (the format's ``refill`` hook), and
every structural tensor is shared with the operators bound before.  A bind of the same values at the same dtype returns the
container bound before while an operator still holds it.  Plans are
memoized in a :class:`PlanCache` keyed by the pattern hash.

``bind`` also takes a ``(nnz,)`` tensor of values, scattered in the same
way with no host round trip, and an apply of the operator carries
gradients back to that tensor (``api.operator``).  :attr:`Plan.transpose`
is the plan of the transposed pattern, from the same cache, so a
structurally symmetric pattern is its own transpose.

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
import weakref
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..autotune.cost import matrix_key, pattern_hash
from ..autotune.registry import available_formats, get_format, on_device
from ..core.cache import BoundedCache
from ..core.ehyb import EHYB, build_ehyb
from ..core.matrices import SparseCSR, from_coo
from ..core.spmv import _values, structure_of
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
    execution token, device), plus the pattern-only partitions (and the
    partition-strategy decisions priced on them) and the host EHYB builds
    the plans of one pattern share (the last build of each pattern and
    partition)."""

    def __init__(self, maxsize: int = 32):
        self._plans = BoundedCache(maxsize=maxsize)
        self._parts = BoundedCache(maxsize=maxsize)
        # (pattern, partition) -> (value key, the last host build)
        self._host = BoundedCache(maxsize=maxsize)
        # autotune_partition's decisions, beside the partitions they priced
        self.partition_tunings = BoundedCache(maxsize=maxsize)

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

    def clear(self) -> None:
        self._plans.clear()
        self._parts.clear()
        self._host.clear()
        self.partition_tunings.clear()

    def stats(self) -> dict:
        """Plan, partition and host-build counts, plus the tuner's decision
        memo (``tune``; its ``disk`` is None: no persistent store)."""
        from ..autotune.tuner import tune_cache_info

        return {"plans": len(self._plans), "partitions": len(self._parts),
                "partition_tunings": len(self.partition_tunings),
                "host_builds": len(self._host), "tune": tune_cache_info()}

    def host_ehyb(self, m: SparseCSR, key: str, part: Partition,
                  value_key: Optional[str] = None) -> EHYB:
        """Host EHYB build of ``m`` (pattern hash ``key``; ``value_key``,
        its :func:`matrix_key`, when the caller has it) on ``part``.

        Two levels, one build kept a pattern: the same values as the last
        build of the pattern on ``part`` return it as it is; new values
        refill it (``EHYB.refill``: no partitioning, no build, no packing)
        and take its place.  The pattern level is keyed by the partition
        too, since a partition depends on the device and on ``k``."""
        pk = (key, part.method, part.n_parts, part.vec_size)
        vk = value_key or matrix_key(m, key)
        hit = self._host.get(pk)
        if hit is not None and hit[0] == vk:
            return hit[1]
        e = hit[1].refill(m.data) if hit is not None else \
            build_ehyb(m, part=part)
        self._host[pk] = (vk, e)
        return e


PLAN_CACHE = PlanCache()


def plan(pattern: SparseCSR, *, execution: Optional[ExecutionConfig] = None,
         device=None, cache: Optional[PlanCache] = None) -> "Plan":
    """Plan the operator lifecycle for a sparsity pattern on ``device``.

    ``pattern`` is a :class:`SparseCSR`; only its ``indptr``/``indices``
    determine the plan (its values seed the autotuner's measured mode and
    the host build the family's byte models read).  ``device`` defaults to
    ``cuda`` and raises without a Hopper card; pass ``device="cpu"`` for
    the plain CPU paths.
    """
    if not isinstance(pattern, SparseCSR):
        raise TypeError(f"plan() takes a SparseCSR pattern, "
                        f"got {type(pattern).__name__}")
    execution = execution or ExecutionConfig()
    if execution.workload == "dist":
        raise NotImplementedError(
            "workload='dist' prices a sharded operator; the distributed "
            "path is not ported yet (ROADMAP Queue 1 item 8)")
    if execution.format != "auto":
        get_format(execution.format)
    for f in execution.candidates or ():
        get_format(f)
    if execution.partition_method is not None:
        get_strategy(execution.partition_method)
    device = resolve_device(device)
    return (PLAN_CACHE if cache is None else cache).plan_for(
        pattern, execution, device)


@dataclasses.dataclass(eq=False)
class Plan:
    """Pattern-only execution plan: format, device, partition — everything
    cacheable per sparsity pattern."""

    key: str                        # sparsity-pattern hash
    n: int
    nnz: int
    format: str                     # the chosen format
    context: str                    # the cost-model context it ranked for
    execution: ExecutionConfig
    device: torch.device
    # the partition the EHYB family builds on (None when no EHYB-family
    # format was possible and none was pinned)
    partition: Optional[Partition]
    pattern: SparseCSR
    cache: PlanCache
    tuning: Any = None              # TuneResult of format="auto", else None
    partition_tuning: Any = None    # PartitionTuneResult, else None
    tuned: Any = None               # resolved TunedParams (never None)
    # what the format's hooks read: the host EHYB build (EHYB family) and
    # the tuned parameters
    _shared: dict = dataclasses.field(default_factory=dict)
    _indices_ok: Optional[bool] = None    # bind-time index check, memoized
    _guards: dict = dataclasses.field(default_factory=dict)  # kind -> guard
    _coo: Optional[Tuple[np.ndarray, np.ndarray]] = None
    _coo_t: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    _value_idx: Optional[torch.Tensor] = None
    # the first bind's container with its value tables dropped
    # (``structure_of``): what every later bind scatters its values into
    _structure: Any = None
    # dtype -> (weak reference to the container last bound from host
    # values at that dtype, matrix_key of those values)
    _last: dict = dataclasses.field(default_factory=dict)
    _scatter_idx: Optional[dict] = None    # value_scatter_index, on device
    _t_order: Optional[np.ndarray] = None
    _t_order_t: Optional[torch.Tensor] = None
    _transpose: Optional["Plan"] = None

    @classmethod
    def _create(cls, pattern: SparseCSR, key: str,
                execution: ExecutionConfig, device: torch.device,
                cache: PlanCache) -> "Plan":
        """The reference's ``Plan._create`` without the mesh and the store:
        resolve the context, autotune the partition strategy when none is
        pinned and an EHYB-family format may be chosen, autotune the format
        when it is ``"auto"``, and resolve the tuned parameters (pin >
        measured sweep > defaults)."""
        from ..autotune.tuner import autotune, autotune_partition
        from ..tuning.params import TunedParams, resolve

        context = "spmv" if execution.workload == "auto" else \
            execution.workload
        fmt = execution.format
        dtype = execution.dtype or torch.float32
        # the EHYB family builds on the partition; the reference asks its
        # ``shard`` hook, which only the family has
        family = (any(get_format(f).partitioned for f in
                      execution.candidates or available_formats())
                  if fmt == "auto" else get_format(fmt).partitioned)
        geometry = partition_sizing(pattern.n, device, execution.k)
        ptuning = part = None
        if execution.partition_method is not None:
            part = cache.partition(pattern, key, execution.partition_method,
                                   *geometry)
        elif family:
            ptuning = autotune_partition(
                pattern, context=context,
                val_bytes=torch.empty((), dtype=dtype).element_size(),
                geometry=geometry, cache=cache)
            part = ptuning.partition
        tuned = execution.tuned
        shared: dict = {}
        tuning = None
        if fmt == "auto":
            if family and part is not None:
                # the family's byte models read a host build on the
                # partition (the pattern's values; a bind of the same
                # values reuses it)
                shared["ehyb"] = cache.host_ehyb(pattern, key, part)
            tuning = autotune(pattern, dtype, mode=execution.mode,
                              candidates=execution.candidates,
                              shared=shared, context=context,
                              k=execution.k, tuned=tuned, device=device)
            fmt = tuning.format
            if tuned is None and tuning.tuned is not None:
                tuned = TunedParams.from_dict(tuning.tuned)
            if not get_format(fmt).partitioned:
                shared.pop("ehyb", None)
        tuned = resolve(tuned)
        shared["tuned"] = tuned
        return cls(key=key, n=pattern.n, nnz=pattern.nnz, format=fmt,
                   context=context, execution=execution, device=device,
                   partition=part, pattern=pattern, cache=cache,
                   tuning=tuning, partition_tuning=ptuning, tuned=tuned,
                   _shared=shared)

    @property
    def partition_strategy(self) -> Optional[str]:
        return None if self.partition is None else self.partition.method

    @property
    def n_parts(self) -> Optional[int]:
        return None if self.partition is None else self.partition.n_parts

    @property
    def vec_size(self) -> Optional[int]:
        return None if self.partition is None else self.partition.vec_size

    # ---- binding -----------------------------------------------------------

    def _as_csr(self, values) -> SparseCSR:
        """Normalize bind input to a SparseCSR on this plan's pattern."""
        if isinstance(values, SparseCSR):
            p = self.pattern
            if values.n != self.n or values.nnz != self.nnz or not (
                    (values.indptr is p.indptr
                     or np.array_equal(values.indptr, p.indptr))
                    and (values.indices is p.indices
                         or np.array_equal(values.indices, p.indices))):
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

    def _validate_bind(self, data) -> None:
        """Reject non-finite values (a numpy array or a tensor) and
        out-of-range column indices at the boundary: both corrupt every
        downstream apply silently (an index past the end makes a kernel
        read out of bounds)."""
        if isinstance(data, torch.Tensor):
            bad = int((~torch.isfinite(data.detach())).sum())
        else:
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
        if self.partition is None:
            raise ValueError(f"this {self.format!r} plan has no partition "
                             f"to build a host EHYB on")
        return self.cache.host_ehyb(self._as_csr(values), self.key,
                                    self.partition)

    def bind(self, values, *, dtype=None, validate: bool = True):
        """Bind entry values to the planned structure -> LinearOperator.

        ``values`` is a :class:`SparseCSR` on this plan's pattern, a
        ``(nnz,)`` per-nnz array in CSR order, or a ``(nnz,)`` tensor;
        ``dtype`` is the table dtype (default: the plan's, else float32).
        The first bind of the plan builds the host tables (built once per
        pattern and partition) and uploads them; every later one scatters
        the values into new tables on the plan's device, sharing the
        structure (:meth:`_scatter`).  Gradients of the applies of an
        operator bound from a tensor reach that tensor.  ``validate``
        rejects non-finite values."""
        from .operator import LinearOperator

        dtype = dtype or self.execution.dtype or torch.float32
        if isinstance(values, torch.Tensor):
            return self._bind_tensor(values, dtype, validate)
        csr = self._as_csr(values)
        if validate:
            self._validate_bind(csr.data)
        mk = matrix_key(csr, self.key)
        slot = self._last.get(dtype)
        obj = slot[0]() if slot is not None and slot[1] == mk else None
        if obj is None:
            if self._structure is None:
                obj = self._first_bind(csr, dtype, mk)
            else:
                # converted as the first bind's upload converts its tables
                # (host float64 to ``dtype``), so both give the same bits
                obj = self._scatter(torch.from_numpy(
                    np.ascontiguousarray(csr.data)).to(device=self.device,
                                                       dtype=dtype))
            self._last[dtype] = (weakref.ref(obj), mk)
        return LinearOperator(plan=self, obj=obj, dtype=dtype, _csr=csr)

    def _first_bind(self, csr: SparseCSR, dtype, mk: Optional[str] = None):
        """The container of ``csr``'s values at ``dtype``; keeps its
        structure for later binds.  The EHYB family's is built from the
        host build of ``csr`` on the partition and uploaded; every other
        format's structure is built from the pattern and the values
        scattered into it (:meth:`_scatter`), as at every rebind.  A
        format without a partition builds no host EHYB."""
        spec = get_format(self.format)
        if spec.partitioned:
            self._shared["ehyb"] = self.cache.host_ehyb(
                csr, self.key, self.partition, mk)
        if spec.structure is None:
            obj = spec.build(csr, self._shared, dtype, self.device)
            self._structure = structure_of(obj)
            return obj
        self._structure = spec.structure(csr, self._shared, dtype,
                                         self.device)
        return self._scatter(_values(csr, dtype, self.device))

    def _scatter(self, vals: torch.Tensor):
        """A container of the per-nnz values ``vals`` (CSR order, on the
        plan's device, in the table dtype): the format's ``refill`` hook
        scatters them into new value tables through its pattern-only
        ``index``, every structural tensor the plan's own."""
        if self._structure is None:
            self._first_bind(self.pattern, vals.dtype)
        spec = get_format(self.format)
        if self._scatter_idx is None:
            self._scatter_idx = on_device(
                spec.index(self.pattern, self._index_shared()), self.device)
        return spec.refill(self._structure, vals, self._scatter_idx)

    def _bind_tensor(self, values: torch.Tensor, dtype, validate: bool):
        """:meth:`bind` of a ``(nnz,)`` tensor: a scatter into new value
        tables on the plan's device (:meth:`_scatter`).  The operator keeps
        ``values`` (moved to the device, still in its autograd graph) for
        the gradients of its applies."""
        from .operator import LinearOperator

        if tuple(values.shape) != (self.nnz,):
            raise ValueError(f"bind() takes a ({self.nnz},) per-nnz value "
                             f"tensor (CSR order); got shape "
                             f"{tuple(values.shape)}")
        if not values.is_floating_point():
            raise TypeError(f"bind() takes floating-point values, got "
                            f"{values.dtype}")
        values = values.to(self.device)
        if validate:
            self._validate_bind(values)
        obj = self._scatter(values.detach().to(dtype))
        return LinearOperator(plan=self, obj=obj, dtype=dtype,
                              _values=values)

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

    def transpose_order(self) -> np.ndarray:
        """``t_order`` with ``Aᵀ.data == A.data[t_order]`` in CSR order
        (host int64; a lexsort of the pattern, memoized)."""
        if self._t_order is None:
            rows, cols = self.coo()
            self._t_order = np.lexsort((rows, cols))
        return self._t_order

    def transpose_order_tensor(self) -> torch.Tensor:
        """:meth:`transpose_order` on the plan's device (memoized)."""
        if self._t_order_t is None:
            self._t_order_t = torch.from_numpy(self.transpose_order()).to(
                self.device)
        return self._t_order_t

    @property
    def transpose(self) -> "Plan":
        """The plan of the transposed pattern, with this plan's execution
        and device, from the same cache: a structurally symmetric pattern
        (the FEM norm) is a cache hit and returns this plan."""
        if self._transpose is None:
            rows, cols = self.coo()
            t = self.transpose_order()
            tp = from_coo(self.n, cols[t], rows[t].astype(np.int32),
                          self.pattern.data[t], sum_duplicates=False)
            self._transpose = self.cache.plan_for(tp, self.execution,
                                                  self.device)
        return self._transpose

    def coo_tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`coo` as int64 tensors on the plan's device (memoized)."""
        if self._coo_t is None:
            self._coo_t = tuple(torch.from_numpy(a).to(self.device)
                                for a in self.coo())
        return self._coo_t

    def _index_shared(self) -> dict:
        """What the format's ``index`` and ``value_index`` hooks read: the
        plan's shared dict, with a host build of the pattern for the EHYB
        family (the indices are pattern-only, so any build on the
        partition serves)."""
        if get_format(self.format).partitioned and \
                "ehyb" not in self._shared:
            self._shared["ehyb"] = self.host_build(self.pattern)
        return self._shared

    def values_of(self, obj) -> torch.Tensor:
        """The per-nnz values in CSR order, read on the device from the
        container ``obj`` bound on this plan (each value once, from the
        tables its apply reads), in the container's value dtype.

        The port's counterpart of the JAX package's probed value maps: the
        positions come from the format's own pattern-only scatter index
        (``FormatSpec.value_index``), so they hold for every bind of the
        plan.  A duplicate entry the format sums into another (the dense
        format's) reads a zero, so a product over the values counts each
        table entry once."""
        if self._value_idx is None:
            self._value_idx = torch.from_numpy(
                get_format(self.format).value_index(
                    self.pattern, self._index_shared(), obj)).to(self.device)
        flat = torch.cat([t.reshape(-1) for t in obj.value_tables()]
                         + [obj.value_tables()[0].new_zeros(1)])
        return flat.index_select(0, self._value_idx)

    def __repr__(self):
        return (f"Plan(n={self.n}, nnz={self.nnz}, format={self.format!r}, "
                f"partition={self.partition_strategy!r}, "
                f"n_parts={self.n_parts}, vec_size={self.vec_size}, "
                f"device={self.device}, key={self.key})")

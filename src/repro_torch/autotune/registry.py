"""Format registry: every device SpMV format behind one interface.

The port of ``repro.autotune.registry``.  A :class:`FormatSpec` bundles what
the framework needs to treat a format as a candidate:

* ``build(m, shared, dtype, device)`` — the device container of ``m``; the
  EHYB family reads the host EHYB build in ``shared["ehyb"]`` (one
  partitioning pass serves all three), the others build from the CSR alone;
  ``shared["tuned"]`` carries the tuned kernel parameters
  (:class:`~repro_torch.tuning.TunedParams`);
* ``model``/``terms`` — modeled bytes of one SpMV, and their split along
  ``cost.TERMS`` (the reference's byte models, the same numbers);
* ``apply``/``permuted`` — the original- and permuted-space applies
  (``permuted`` None for the formats without a reordered space);
* ``kernel`` — what runs the applies: ``"cuda"`` for the hand-written
  kernels (``ehyb_packed``), ``"plain"`` for plain PyTorch (every other
  format, whose reference apply is XLA);
* ``index``/``refill``/``value_index`` — the value path: where each
  nonzero's value goes in the value tables (pattern-only, host arrays),
  the device scatter that fills new tables through that index sharing
  every structural tensor, and where each value is read back
  (``Plan.values_of``);
* ``structure`` — for the formats whose first bind fills its value tables
  through the same scatter as every rebind (all but ``ehyb`` and
  ``ehyb_packed``, which upload the host build's tables): the container
  with placeholder value tables;
* ``fallback``/``fallback_permuted`` — the guarded apply's unfused level
  (``ehyb_packed`` only: ``use_er_kernel=False``);
* ``partitioned`` — built on the plan's partition (the EHYB family).  The
  reference tells the family by its ``shard`` hook; the port has no
  ``dist/`` yet and names it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.ehyb import EHYB, build_buckets, pack_staircase
from ..core.matrices import SparseCSR
from ..core.spmv import (COODevice, DenseDevice, EHYBBucketsDevice,
                         EHYBDevice, EHYBPackedDevice, ELLDevice, HYBDevice,
                         _values, coo_spmv, dense_spmv, ehyb_buckets_spmv,
                         ehyb_buckets_spmv_permuted, ehyb_spmv,
                         ehyb_spmv_permuted, ell_spmv, fill_values, hyb_spmv,
                         hyb_width, index_positions, scatter_values,
                         value_index, value_scatter_index)
from ..kernels.ops import ehyb_spmv_packed, ehyb_spmv_packed_permuted
from .cost import MatrixStats, _x_stream_bytes


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    name: str
    build: Callable      # (m, shared, dtype, device) -> device container
    model: Callable      # (m, stats, vb, shared, context, k) -> bytes
    apply: Callable      # (obj, x) -> y, original space
    index: Callable      # (m, shared) -> {table: rounds}, host arrays
    # (structure, vals, index on the device) -> obj: the per-nnz values
    # ``vals`` (CSR order, on the device, in the table dtype) scattered into
    # new value tables, every structural tensor shared with ``structure``
    refill: Callable
    value_index: Callable   # (m, shared, obj) -> (nnz,) positions
    permuted: Optional[Callable] = None   # (obj, x_new) -> y_new
    kernel: str = "plain"                 # "cuda": the applies launch kernels
    partitioned: bool = False             # built on the plan's partition
    structure: Optional[Callable] = None  # (m, shared, dtype, device) -> obj
    terms: Optional[Callable] = None      # per-term split of ``model``
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


def available_formats() -> list[str]:
    return sorted(FORMATS)


def build_format(name: str, m: SparseCSR, dtype=None,
                 shared: Optional[dict] = None, device=None):
    """``name``'s device container for ``m`` on ``device`` (default
    ``cuda``)."""
    from ..api.plan import resolve_device

    return get_format(name).build(m, {} if shared is None else shared,
                                  dtype or torch.float32,
                                  resolve_device(device))


def on_device(index, device):
    """A host index (nested tuples/dicts of numpy arrays) as int64 tensors
    on ``device``."""
    if isinstance(index, dict):
        return {k: on_device(v, device) for k, v in index.items()}
    if isinstance(index, tuple):
        return tuple(on_device(v, device) for v in index)
    return torch.from_numpy(np.ascontiguousarray(index)).to(device)


# ---------------------------------------------------------------------------
# the shared host EHYB build and its views
# ---------------------------------------------------------------------------

def shared_ehyb(m: SparseCSR, shared: dict) -> EHYB:
    """The host EHYB build the family shares: ``shared["ehyb"]`` (a plan
    puts its own there), else a bfs build at the reference's geometry from
    the port's plan cache, as the reference falls back to its own."""
    if "ehyb" not in shared:
        from ..api.plan import PLAN_CACHE
        from ..core.partition import choose_vec_size
        from .cost import pattern_hash

        key = pattern_hash(m)
        part = PLAN_CACHE.partition(m, key, "bfs", *choose_vec_size(m.n))
        shared["ehyb"] = PLAN_CACHE.host_ehyb(m, key, part)
    return shared["ehyb"]


def shared_packed(e: EHYB):
    """Packed-staircase view of a host EHYB build, memoized on it."""
    pk = getattr(e, "_packed", None)
    if pk is None:
        pk = e._packed = pack_staircase(e)
    return pk


def _tuned_n_buckets(shared: dict) -> int:
    """The bucketed format's width-class count: the tuned value when the
    caller planned one (``shared["tuned"]``), else the default 4."""
    tuned = shared.get("tuned")
    return tuned.n_buckets if tuned is not None else 4


def memo_buckets(e: EHYB, n_buckets: int = 4):
    """Bucketed view of a host EHYB build, memoized per bucket count: the
    default count in ``_buckets``, others in ``_buckets_nb`` (both carried
    through ``EHYB.refill``)."""
    if n_buckets == 4:
        b = getattr(e, "_buckets", None)
        if b is None:
            b = e._buckets = build_buckets(e)
        return b
    memo = getattr(e, "_buckets_nb", None)
    if memo is None:
        memo = e._buckets_nb = {}
    b = memo.get(n_buckets)
    if b is None:
        b = memo[n_buckets] = build_buckets(e, n_buckets=n_buckets)
    return b


def shared_buckets(m: SparseCSR, shared: dict):
    """Width-bucketed view of the shared EHYB build at the tuned count."""
    return memo_buckets(shared_ehyb(m, shared), _tuned_n_buckets(shared))


# ---------------------------------------------------------------------------
# builders, scatter indices and read-back positions
# ---------------------------------------------------------------------------

def _scatter_build(structure: Callable, index: Callable) -> Callable:
    """A ``build`` that fills ``structure``'s value tables through the
    format's own scatter (:func:`~repro_torch.core.spmv.fill_values`), as
    every rebind does."""
    def build(m, shared, dtype, device):
        return fill_values(structure(m, shared, dtype, device),
                           _values(m, dtype, device),
                           on_device(index(m, shared), device))
    return build


def _positions(index: Callable) -> Callable:
    def value_index_(m, shared, obj):
        return index_positions(index(m, shared), obj, m.nnz)
    return value_index_


def _from_csr(cls):
    """(structure, index) hooks of a container built from the CSR alone."""
    return (lambda m, shared, dtype, device:
            cls.structure(m, dtype, device=device),
            lambda m, shared: cls.index(m))


def _buckets_structure(m, shared, dtype, device):
    return EHYBBucketsDevice.structure(shared_buckets(m, shared), dtype,
                                       device=device)


def _buckets_index(m, shared):
    return EHYBBucketsDevice.index(shared_buckets(m, shared))


def _build_ehyb(m, shared, dtype, device) -> EHYBDevice:
    return EHYBDevice.from_ehyb(shared_ehyb(m, shared), dtype, device=device)


def _build_ehyb_packed(m, shared, dtype, device) -> EHYBPackedDevice:
    tuned = shared.get("tuned")
    return EHYBPackedDevice.from_packed(
        shared_packed(shared_ehyb(m, shared)), dtype, device=device,
        rhs_chunk=None if tuned is None else tuned.rhs_chunk)


def _ehyb_index(m, shared):
    return value_scatter_index(shared_ehyb(m, shared))


def _packed_index(m, shared):
    e = shared_ehyb(m, shared)
    return value_scatter_index(e, shared_packed(e))


def _ehyb_positions(m, shared, obj):
    return value_index(shared_ehyb(m, shared))


def _packed_positions(m, shared, obj):
    e = shared_ehyb(m, shared)
    return value_index(e, shared_packed(e))


def _packed_unfused(d, x):
    return ehyb_spmv_packed(d, x, use_er_kernel=False)


def _packed_unfused_permuted(d, x_new):
    return ehyb_spmv_packed_permuted(d, x_new, use_er_kernel=False)


# ---------------------------------------------------------------------------
# byte models (one SpMV, fp-width ``vb``); x-stream bounds in cost.py.
# ``context``: "spmv" = one-shot original-space call; "solver" = one
# permuted-space hot-loop iteration (the EHYB family drops the perm round
# trip; the other formats have no reordered space).  ``k``: rhs batch width
# — A-sided streams are read once, every x/y-sided term scales ×k.
# ---------------------------------------------------------------------------

def _model_csr(m, stats: MatrixStats, vb: int, shared,
               context: str = "spmv", k: int = 1) -> int:
    # COO stream realization of CSR semantics: rows + cols int32 per nnz
    idx = 8 * stats.nnz
    return (idx + vb * stats.nnz
            + k * (_x_stream_bytes(stats, vb) + vb * stats.n))


def _model_ell(m, stats: MatrixStats, vb: int, shared,
               context: str = "spmv", k: int = 1) -> int:
    stored = stats.n * stats.max_row
    return (stored * (vb + 4)
            + k * (_x_stream_bytes(stats, vb) + vb * stats.n))


def _hyb_split(m) -> tuple[int, int]:
    """(ELL width, spilled entries) of HYB."""
    kq = hyb_width(m)
    return kq, int(np.maximum(m.row_lengths() - kq, 0).sum())


def _model_hyb(m, stats: MatrixStats, vb: int, shared,
               context: str = "spmv", k: int = 1) -> int:
    kq, spill = _hyb_split(m)
    ell = stats.n * kq * (vb + 4)
    coo = spill * (vb + 8)
    return ell + coo + k * (_x_stream_bytes(stats, vb) + vb * stats.n)


def _ehyb_space(context: str) -> str:
    return "permuted" if context == "solver" else "original"


def _model_ehyb(m, stats, vb, shared, context: str = "spmv",
                k: int = 1) -> int:
    return shared_ehyb(m, shared).bytes_moved(
        vb, layout="tile", space=_ehyb_space(context), fused_er=True,
        k=k)["total"]


def _model_ehyb_bucketed(m, stats, vb, shared, context: str = "spmv",
                         k: int = 1) -> int:
    return shared_buckets(m, shared).bytes_moved(
        vb, space=_ehyb_space(context), fused_er=True, k=k)["total"]


def _model_ehyb_packed(m, stats, vb, shared, context: str = "spmv",
                       k: int = 1) -> int:
    return shared_ehyb(m, shared).bytes_moved(
        vb, layout="packed", space=_ehyb_space(context), fused_er=True,
        k=k)["total"]


def _model_dense(m, stats, vb, shared, context: str = "spmv",
                 k: int = 1) -> int:
    return stats.n * stats.n * vb + k * 2 * stats.n * vb


# per-term breakdowns (cost.TERMS axes) — the same totals as the models
# above; for the unpartitioned formats: A-stream -> "ell", uncached x
# gather -> "er", output -> "y"

def _terms_csr(m, stats, vb, shared, context="spmv", k=1):
    return {"ell": (8 + vb) * stats.nnz,
            "er": k * _x_stream_bytes(stats, vb),
            "y": k * vb * stats.n}


def _terms_ell(m, stats, vb, shared, context="spmv", k=1):
    return {"ell": stats.n * stats.max_row * (vb + 4),
            "er": k * _x_stream_bytes(stats, vb),
            "y": k * vb * stats.n}


def _terms_hyb(m, stats, vb, shared, context="spmv", k=1):
    kq, spill = _hyb_split(m)
    return {"ell": stats.n * kq * (vb + 4),
            "er": spill * (vb + 8) + k * _x_stream_bytes(stats, vb),
            "y": k * vb * stats.n}


def _terms_dense(m, stats, vb, shared, context="spmv", k=1):
    return {"ell": stats.n * stats.n * vb, "x_cache": k * stats.n * vb,
            "y": k * stats.n * vb}


def _split_bytes_moved(d: dict) -> dict:
    return {t: v for t, v in d.items() if t != "total"}


def _terms_ehyb(m, stats, vb, shared, context="spmv", k=1):
    return _split_bytes_moved(shared_ehyb(m, shared).bytes_moved(
        vb, layout="tile", space=_ehyb_space(context), fused_er=True, k=k))


def _terms_ehyb_bucketed(m, stats, vb, shared, context="spmv", k=1):
    return _split_bytes_moved(shared_buckets(m, shared).bytes_moved(
        vb, space=_ehyb_space(context), fused_er=True, k=k))


def _terms_ehyb_packed(m, stats, vb, shared, context="spmv", k=1):
    return _split_bytes_moved(shared_ehyb(m, shared).bytes_moved(
        vb, layout="packed", space=_ehyb_space(context), fused_er=True, k=k))


def _scatter_format(name, hooks, model, terms, apply, description,
                    **kw) -> FormatSpec:
    """A format whose value tables are filled through its scatter at every
    bind, the first included; ``hooks`` is (structure, index)."""
    structure, index = hooks
    return FormatSpec(name, _scatter_build(structure, index), model, apply,
                      index, fill_values, _positions(index),
                      structure=structure, terms=terms,
                      description=description, **kw)


register_format(_scatter_format(
    "csr", _from_csr(COODevice), _model_csr, _terms_csr, coo_spmv,
    "COO/CSR gather + segment-sum stream (the paper's baseline)"))
register_format(_scatter_format(
    "ell", _from_csr(ELLDevice), _model_ell, _terms_ell, ell_spmv,
    "ELLPACK padded to the global max row width"))
register_format(_scatter_format(
    "hyb", _from_csr(HYBDevice), _model_hyb, _terms_hyb, hyb_spmv,
    "classic HYB (Bell & Garland): ELL to 90th pct + COO spill"))
register_format(FormatSpec(
    "ehyb", _build_ehyb, _model_ehyb, ehyb_spmv, _ehyb_index,
    scatter_values, _ehyb_positions, permuted=ehyb_spmv_permuted,
    partitioned=True, terms=_terms_ehyb,
    description="EHYB uniform tiles, uint16 local cols; plain PyTorch "
                "apply"))
register_format(_scatter_format(
    "ehyb_bucketed", (_buckets_structure, _buckets_index),
    _model_ehyb_bucketed, _terms_ehyb_bucketed, ehyb_buckets_spmv,
    "EHYB with width-bucketed partition tiles; plain PyTorch apply",
    permuted=ehyb_buckets_spmv_permuted, partitioned=True))
register_format(FormatSpec(
    "ehyb_packed", _build_ehyb_packed, _model_ehyb_packed, ehyb_spmv_packed,
    _packed_index, scatter_values, _packed_positions,
    permuted=ehyb_spmv_packed_permuted, kernel="cuda", partitioned=True,
    terms=_terms_ehyb_packed, fallback=_packed_unfused,
    fallback_permuted=_packed_unfused_permuted,
    description="EHYB packed staircase; fused CUDA kernel on the card"))
register_format(_scatter_format(
    "dense", _from_csr(DenseDevice), _model_dense, _terms_dense,
    dense_spmv, "dense matmul (wins only on tiny/near-dense matrices)"))

"""Sparsity-pattern statistics and the bytes-moved cost model.

The port of ``repro.autotune.cost``: the same numbers, bit for bit, for the
same pattern and partition.  SpMV is memory-bound, so modeled device-memory
bytes per SpMV (the paper's §3.4 accounting) rank formats without touching
the device.  Formats that gather x *uncached* have data-dependent x
traffic; it is bracketed between the two classical bounds — perfect cache
(each x entry read once) and no cache (one read per nnz) — and ranked on
the midpoint, the same treatment for every uncached format.  EHYB's cached
reads are exact (one shared-memory fill per partition).

**Workload context.**

* ``context="spmv"`` — a one-shot original-space call.  EHYB pays the
  per-call permutation round trip (``perm`` gather in, ``inv_perm`` gather
  out: 2·n_pad·val_bytes), with the ER contribution fused into the kernel.
* ``context="solver"`` — an iterative hot loop in the permuted space: the
  permutation is hoisted out of the loop, so the per-iteration bytes drop
  by exactly the round-trip term.
* ``context="dist"`` — one iteration sharded over several devices, which
  adds an interconnect term.  It needs the halo plans of ``dist/`` (ROADMAP
  Queue 1 item 8), which the port does not have yet, and raises
  ``NotImplementedError``.

Non-EHYB formats have no reordered space; their accounting is
context-independent.  The pattern and matrix hashes key the plan cache and
the tuner's decisions; they equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np

from ..core.matrices import SparseCSR


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    """Pattern-only statistics that drive the cost model."""

    n: int
    nnz: int
    avg_row: float
    max_row: int
    row_cv: float            # row-length coefficient of variation (std/mean)
    density: float
    empty_rows: int

    @classmethod
    def from_csr(cls, m: SparseCSR) -> "MatrixStats":
        lens = m.row_lengths()
        avg = float(lens.mean()) if m.n else 0.0
        return cls(
            n=m.n, nnz=m.nnz, avg_row=avg,
            max_row=int(lens.max()) if m.n else 0,
            row_cv=float(lens.std() / max(avg, 1e-12)) if m.n else 0.0,
            density=m.nnz / max(m.n * m.n, 1),
            empty_rows=int((lens == 0).sum()),
        )


def matrix_stats(m: SparseCSR) -> MatrixStats:
    return MatrixStats.from_csr(m)


def _x_stream_bytes(stats: MatrixStats, val_bytes: int) -> int:
    """Midpoint of the [perfect-cache, no-cache] x-traffic bracket."""
    return (stats.n + stats.nnz) * val_bytes // 2


def pattern_hash(m: SparseCSR) -> str:
    """Stable hash of the sparsity pattern (values excluded: a plan depends
    only on where the entries are, not what they are)."""
    h = hashlib.sha256()
    h.update(np.int64(m.n).tobytes())
    h.update(np.ascontiguousarray(m.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(m.indices, dtype=np.int32).tobytes())
    return h.hexdigest()[:16]


def matrix_key(m: SparseCSR, pattern: Optional[str] = None) -> str:
    """Pattern *and* values hash — the key for caches that hold built device
    arrays.  ``pattern`` (a precomputed :func:`pattern_hash` of ``m``) skips
    re-hashing the index arrays.  The value dtype is mixed in, so identical
    bytes of different dtypes do not collide."""
    h = hashlib.sha256()
    h.update((pattern or pattern_hash(m)).encode())
    h.update(np.asarray(m.data).dtype.str.encode())
    h.update(np.ascontiguousarray(m.data).tobytes())
    return h.hexdigest()[:16]


CONTEXTS = ("spmv", "solver", "dist")

#: Canonical byte-term axes of the cost model.
#: ``ell``  — the sequential A-stream (values + column metadata);
#: ``x_cache`` — x reads served by the explicit cache (EHYB) or full reuse
#:           (dense);
#: ``er``   — random-gather traffic: ER tiles plus any *uncached* x stream;
#: ``y``    — the output store;
#: ``perm`` — the original-space permutation round trip (EHYB, "spmv" only);
#: ``interconnect`` — scheduled halo / all-gather words ("dist" only).
TERMS = ("ell", "x_cache", "er", "y", "perm", "interconnect")


def _check_context(context: str) -> None:
    if context not in CONTEXTS:
        raise ValueError(f"unknown context {context!r}; have {CONTEXTS}")
    if context == "dist":
        raise NotImplementedError(
            "context='dist' prices the interconnect of a sharded operator, "
            "which needs the halo plans of dist/ (ROADMAP Queue 1 item 8); "
            "not ported yet")


def allgather_penalty_bytes(n: int, n_dev: int, val_bytes: int,
                            k: int = 1) -> int:
    """Mesh-total interconnect bytes an iteration for a format with no
    partition structure: every device gathers the remote x
    (n − n/n_dev words) and reduces its remote y contribution back; a
    k-wide rhs multiplies the whole penalty."""
    return n_dev * 2 * (n - n // max(n_dev, 1)) * val_bytes * k


def estimate_bytes(m: SparseCSR, fmt: str, val_bytes: int = 4,
                   shared: Optional[dict] = None,
                   stats: Optional[MatrixStats] = None,
                   context: str = "spmv", k: int = 1) -> int:
    """Modeled bytes of one SpMV of ``m`` in format ``fmt``.

    ``context="solver"`` models one hot-loop iteration in the operator's
    native (permuted) space; ``"spmv"`` models a one-shot original-space
    call.  ``k`` is the rhs batch width of a multi-rhs (SpMM) apply:
    A-sided streams are read once regardless of k, x/y-sided streams scale
    ×k, so the ranking is k-dependent.  ``shared`` carries the host EHYB
    build the family's models read (``shared["ehyb"]``; without it, a bfs
    build at the reference's geometry from the port's plan cache)."""
    from .registry import get_format

    _check_context(context)
    if not isinstance(k, int) or k < 1:
        raise ValueError(f"k must be a positive int, got {k!r}")
    shared = {} if shared is None else shared
    stats = stats or matrix_stats(m)
    return int(get_format(fmt).model(m, stats, val_bytes, shared,
                                     context=context, k=k))


def estimate_terms(m: SparseCSR, fmt: str, val_bytes: int = 4,
                   shared: Optional[dict] = None,
                   stats: Optional[MatrixStats] = None,
                   context: str = "spmv", k: int = 1) -> Dict[str, int]:
    """Per-term byte breakdown of one SpMV of ``m`` in format ``fmt``: the
    same accounting as :func:`estimate_bytes` (the terms sum to it), split
    along the :data:`TERMS` axes."""
    from .registry import get_format

    _check_context(context)
    shared = {} if shared is None else shared
    stats = stats or matrix_stats(m)
    spec = get_format(fmt)
    if spec.terms is not None:
        raw = spec.terms(m, stats, val_bytes, shared, context=context, k=k)
    else:
        raw = {"ell": spec.model(m, stats, val_bytes, shared,
                                 context=context, k=k)}
    return {t: int(raw.get(t, 0)) for t in TERMS}


def model_table(m: SparseCSR, val_bytes: int = 4,
                candidates=None, shared: Optional[dict] = None,
                context: str = "spmv", k: int = 1) -> Dict[str, int]:
    """Per-format modeled bytes; one shared EHYB build serves the family."""
    from .registry import available_formats

    shared = {} if shared is None else shared
    stats = matrix_stats(m)
    return {f: estimate_bytes(m, f, val_bytes, shared, stats, context, k)
            for f in (candidates or available_formats())}


def rank_formats(m: SparseCSR, val_bytes: int = 4, candidates=None,
                 shared: Optional[dict] = None,
                 context: str = "spmv", k: int = 1) -> list[tuple[str, int]]:
    """Formats sorted by modeled bytes, cheapest first (ties: by name, so
    rankings are deterministic)."""
    table = model_table(m, val_bytes, candidates, shared, context, k)
    return sorted(table.items(), key=lambda kv: (kv[1], kv[0]))


def partition_cost(m: SparseCSR, part, val_bytes: int = 4,
                   context: str = "spmv", n_dev: int = 1, k: int = 1,
                   col_bytes: int = 2, sublane: int = 8) -> Dict[str, int]:
    """Modeled bytes of one EHYB SpMV under ``part``, priced from the
    pattern and partition alone, before any tables are built.

    Reproduces ``EHYB.bytes_moved(layout="tile", fused_er=True,
    space=permuted-for-solver)`` on the container ``build_ehyb(m,
    part=part)`` would produce, term for term, so ``autotune_partition``
    can rank every registered strategy without building an EHYB each.
    One value-dependence caveat: the built container's ER term vanishes
    when every ER *value* is an explicit zero; this pattern-level pricer
    keeps the term whenever ER *entries* exist.  ``n_dev`` is the mesh
    size of the ``dist`` context, which raises until ``dist/`` is
    ported."""
    _check_context(context)
    n, n_pad = m.n, part.n_pad
    P, V = part.n_parts, part.vec_size
    rows = np.repeat(np.arange(n, dtype=np.int64), m.row_lengths())
    cols = m.indices.astype(np.int64)
    pv = part.part_vec
    same = pv[rows] == pv[cols]
    widths = np.bincount(rows[same], minlength=n)
    ell = P * V * max(int(widths.max()), 1) * (val_bytes + col_bytes)
    x_cache = n_pad * val_bytes * k
    out_counts = np.bincount(rows[~same], minlength=n)
    live = np.flatnonzero(out_counts)
    if len(live):
        er_width = int(out_counts.max())
        er_rows = max(sublane, -(-len(live) // sublane) * sublane)
        # grouped-ER tile height: max live ER rows owned by one partition,
        # sublane-aligned (group_er_by_partition's E)
        ep = max(sublane,
                 -(-int(np.bincount(pv[live], minlength=P).max())
                   // sublane) * sublane)
        er = (P * ep * er_width * (val_bytes + 4)
              + min(er_rows * er_width, n_pad) * val_bytes * k
              + P * ep * 4)
    else:
        er = 0
    y = n_pad * val_bytes * k
    perm = 2 * n_pad * val_bytes * k if context == "spmv" else 0
    return {"ell": ell, "x_cache": x_cache, "er": er, "y": y, "perm": perm,
            "interconnect": 0,
            "total": ell + x_cache + er + y + perm}

"""Deprecated shim over ``repro_torch.dist`` — the sharded-operator package.

The port of ``repro.core.dist_spmv``.  Distribution is a package of its own,
:mod:`repro_torch.dist`: a :class:`~repro_torch.dist.HaloPlan` computed once
per sparsity pattern (for every device, the sorted unique remote columns its
ER entries touch, an ``all_to_all`` schedule choosing per device pair
between fetching x words and pushing partial-y words, and ER columns
renumbered into the compact local space ``[0, local_size + halo)``), and a
:class:`~repro_torch.dist.ShardedOperator` with the full operator API whose
per-iteration communication is ``halo_words`` instead of the ``2·n_pad·r``
words an all-gather and a reduce-scatter moved (that baseline survives as
:func:`repro_torch.dist.build_allgather_spmv`).

``build_dist_spmv`` below is kept for source compatibility: it builds a
:class:`~repro_torch.dist.ShardedOperator` and returns its bare ``x -> y``
closure.  New code uses ``repro_torch.api.plan(A, mesh=mesh).bind(A)``.
"""

from __future__ import annotations

import warnings

# The shim's public surface: only names that exist in ``repro_torch.dist``
# may be forwarded (the list is import-audited by the tests).
__all__ = ["build_dist_spmv"]

# Names forwarded (lazily, with a DeprecationWarning) to ``repro_torch.dist``
# for source compatibility.  Everything else raises AttributeError.
_FORWARDED = ("ShardedOperator", "EHYBShards", "HaloPlan",
              "build_halo_plan", "build_sharded_spmv",
              "build_allgather_spmv")


def __getattr__(name: str):
    if name in _FORWARDED:
        from .. import dist as _dist

        warnings.warn(
            f"core.dist_spmv.{name} is deprecated; import it from "
            f"repro_torch.dist (or use repro_torch.api.plan(A, mesh=...))",
            DeprecationWarning, stacklevel=2)
        return getattr(_dist, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def build_dist_spmv(dev, mesh, axis: str = "data", space: str = "original"):
    """Deprecated: returns the matvec of a
    :class:`repro_torch.dist.ShardedOperator`.

    ``dev`` may be a host ``SparseCSR`` or ``EHYB`` build, a bound
    EHYB-family operator or a bare ``EHYBDevice`` (applies only: its
    pseudo host build has no fill plan).  Any ``n_parts``/``n_dev``
    combination works (partitions are padded), and a non-float input is
    promoted to the value dtype."""
    from ..dist.operator import _build_sharded_operator

    warnings.warn(
        "core.dist_spmv.build_dist_spmv is deprecated; use "
        "repro_torch.api.plan(A, mesh=mesh).bind(A) (full operator API: "
        "permuted space, value refills, distributed solve)",
        DeprecationWarning, stacklevel=2)
    if space not in ("original", "permuted"):
        raise ValueError(f"unknown space {space!r}")
    op = _build_sharded_operator(dev, mesh, axis)
    return op.matvec_permuted if space == "permuted" else op.matvec

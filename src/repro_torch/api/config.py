"""Operator API configuration: execution spaces and planning knobs — the
port of ``repro.api.config``."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Tuple


class Space(enum.Enum):
    """Vector space an operator apply reads/writes.

    ``ORIGINAL``   — the caller's coordinates: length-``n`` vectors indexed
                     by matrix row/column.
    ``PERMUTED``   — the format's execution space: symmetrically reordered
                     and padded to ``n_pad`` (EHYB family).  Hot loops hoist
                     the ``ORIGINAL ↔ PERMUTED`` gathers out of the loop via
                     :meth:`repro_torch.api.LinearOperator.to_space` /
                     :meth:`~repro_torch.api.LinearOperator.from_space`.
    """

    ORIGINAL = "original"
    PERMUTED = "permuted"


# workload -> autotuner cost-model context (see repro_torch.autotune.cost)
WORKLOADS = ("auto", "spmv", "solver", "dist")


def resolve_context(workload: str, mesh: bool, n_dev: int = 1) -> str:
    """The cost-model context a plan of ``workload`` ranks in: with a mesh
    (``mesh`` True) of ``n_dev > 1`` ranks it is "dist" ("auto" or "dist"
    only); on a one-rank mesh there is no interconnect to price, and "auto"
    and "dist" rank as "solver"; without a mesh "auto" is "spmv" and
    "dist" raises."""
    if mesh and n_dev > 1:
        if workload not in ("auto", "dist"):
            raise ValueError(
                f"workload {workload!r} conflicts with a {n_dev}-rank mesh: "
                f"sharded plans rank with the interconnect-aware 'dist' "
                f"cost model")
        return "dist"
    if mesh:
        return workload if workload in ("spmv", "solver") else "solver"
    if workload == "dist":
        raise ValueError("workload='dist' prices a multi-rank mesh; pass "
                         "mesh= with more than one rank")
    return "spmv" if workload == "auto" else workload


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Value-independent planning knobs (hashable — part of the plan key).

    format            — "auto" (the cost-model autotuner) or a registered
                        format name ("csr", "ell", "hyb", "ehyb",
                        "ehyb_bucketed", "ehyb_packed", "dense").
    mode              — autotuner mode: "model" ranks on modeled bytes;
                        "measure" also times the top candidates on the
                        plan's device and sweeps the winner's tunable
                        parameters.
    workload          — what the byte model prices one apply as: "spmv"
                        (one-shot original-space call), "solver" (permuted-
                        space hot-loop iteration), "dist" (sharded hot-loop
                        iteration, interconnect term included).  "auto"
                        resolves to "dist" on a multi-rank mesh, "solver"
                        on a one-rank mesh (no interconnect to price) and
                        "spmv" without a mesh (:func:`resolve_context`).
    dtype             — default value dtype for ``Plan.bind`` (None = fp32).
    partition_method  — EHYB partition strategy ("natural", "bfs",
                        "mincut", "hub").  None (the default) lets
                        ``plan()`` autotune it with the partition-level
                        bytes-moved model at the plan's partition geometry
                        (``autotune_partition``) whenever an EHYB-family
                        format may be selected.
    candidates        — restrict the autotuner's candidate set.
    k                 — expected rhs batch width of the applies (SpMM).  The
                        cost model scales its x/y-sided traffic ×k, so the
                        format choice can flip with k; on the card the plan
                        also sizes its partitions so that a block holds
                        ``min(k, 16)`` rhs columns of its x-slice and output
                        tile.  Applies take any rhs width at run time.
    tuned             — pinned tunable kernel parameters
                        (:class:`repro_torch.tuning.TunedParams`, or a dict
                        of knob names; validated against the declared
                        bounds).  None lets ``plan()`` resolve them: the
                        measured sweep under ``mode="measure"``, else the
                        defaults.  Part of the plan identity.
    """

    format: str = "auto"
    mode: str = "model"
    workload: str = "auto"
    dtype: Any = None
    partition_method: Optional[str] = None
    candidates: Optional[Tuple[str, ...]] = None
    k: int = 1
    tuned: Optional[Any] = None

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(f"workload must be one of {WORKLOADS}, "
                             f"got {self.workload!r}")
        if self.mode not in ("model", "measure"):
            raise ValueError(f"mode must be 'model' or 'measure', "
                             f"got {self.mode!r}")
        if self.candidates is not None and not isinstance(self.candidates,
                                                          tuple):
            object.__setattr__(self, "candidates", tuple(self.candidates))
        if not isinstance(self.k, int) or self.k < 1:
            raise ValueError(f"k must be a positive int, got {self.k!r}")
        if self.tuned is not None:
            from ..tuning.params import TunedParams

            if isinstance(self.tuned, dict):
                object.__setattr__(self, "tuned",
                                   TunedParams.from_dict(self.tuned))
            elif not isinstance(self.tuned, TunedParams):
                raise TypeError("tuned must be a repro_torch.tuning."
                                "TunedParams or a dict, got "
                                f"{type(self.tuned).__name__}")

    def token(self) -> tuple:
        """Hashable identity for the plan cache."""
        return (self.format, self.mode, self.workload,
                None if self.dtype is None else str(self.dtype),
                self.partition_method, self.candidates, self.k,
                None if self.tuned is None else self.tuned.token())

"""Operator API configuration: execution spaces and planning knobs — the
port of ``repro.api.config`` for the knobs this slice carries."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


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


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Value-independent planning knobs (hashable — part of the plan key).

    format            — a registered format name ("ehyb", "ehyb_packed");
                        "auto" (the reference's default) needs the
                        autotuner, which is not ported yet, and raises.
    dtype             — default value dtype for ``Plan.bind`` (None = fp32).
    partition_method  — EHYB partition strategy ("natural", "bfs", "mincut",
                        "hub"); None (the reference's default, autotuned
                        there) raises until the autotuner is ported.
    k                 — expected rhs batch width of the applies (SpMM).  On
                        the card the plan sizes its partitions so that a
                        block holds ``min(k, 16)`` rhs columns of its x-slice
                        and output tile; on the CPU it changes nothing.
                        Applies still take any rhs width at run time — ``k``
                        only steers planning.
    """

    format: str = "auto"
    dtype: Any = None
    partition_method: Optional[str] = None
    k: int = 1

    def __post_init__(self):
        if not isinstance(self.k, int) or self.k < 1:
            raise ValueError(f"k must be a positive int, got {self.k!r}")

    def token(self) -> tuple:
        """Hashable identity for the plan cache."""
        return (self.format, None if self.dtype is None else str(self.dtype),
                self.partition_method, self.k)

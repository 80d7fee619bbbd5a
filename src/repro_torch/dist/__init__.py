"""Sharded EHYB execution — the paper's explicit caching lifted to the mesh.

The port of ``repro.dist`` onto ``torch.distributed`` (one process a
device).  The single-device EHYB story is: cache the partition-local slice
of x, compress the column index into that slice, and make only the small
"exceptional" remainder (ER) pay long-range traffic.  This package applies
the same decomposition one level up, across devices:

  partition-local x-slice  ->  the rank-local shard of x (never moves)
  compact uint16 column    ->  ER columns renumbered into the compact local
                               space [0, local_size + halo_size)
  ER remainder traffic     ->  a precomputed halo exchange moving only the
                               words the ER entries actually reference

``halo.py`` computes the :class:`HaloPlan` at partition time (pattern-only,
so value refills reuse it), ``operator.py`` wraps it into a
:class:`ShardedOperator` whose ELL and ER stages run on the hand-written
kernels, and ``allgather.py`` keeps the gather-everything implementation
as the accounting baseline.
"""

from .halo import HaloPlan, build_halo_plan, ehyb_halo_words
from .operator import EHYBShards, ShardedOperator, build_sharded_spmv
from .allgather import build_allgather_spmv

__all__ = [
    "HaloPlan", "build_halo_plan", "ehyb_halo_words",
    "EHYBShards", "ShardedOperator", "build_sharded_spmv",
    "build_allgather_spmv",
]

"""Format autotuning: the registry of the seven formats, the bytes-moved
cost model and the tuner (the port of ``repro.autotune``).

``registry`` — one :class:`FormatSpec` per device format: how to build it,
               apply it, refill its values, and its modeled bytes a SpMV;
``cost``     — sparsity-pattern statistics and the §3.4 bytes-moved cost
               model evaluated per format without building device tables;
``tuner``    — ``autotune(A)``: rank by modeled bytes, optionally time the
               top candidates on the plan's device, cache the choice keyed
               by the sparsity-pattern hash; ``autotune_partition`` picks
               the partition strategy.
"""

from .registry import (FORMATS, FormatSpec, available_formats, build_format,
                       get_format, register_format)
from .cost import (CONTEXTS, TERMS, MatrixStats, allgather_penalty_bytes,
                   estimate_bytes, estimate_terms, matrix_key, matrix_stats,
                   model_table, partition_cost, pattern_hash, rank_formats)
from .tuner import (PartitionTuneResult, TuneResult, autotune,
                    autotune_partition, clear_cache, tune_cache_info)

__all__ = [
    "FORMATS", "FormatSpec", "available_formats", "build_format",
    "get_format", "register_format",
    "CONTEXTS", "TERMS", "MatrixStats", "allgather_penalty_bytes",
    "estimate_bytes", "estimate_terms", "matrix_key", "matrix_stats",
    "model_table", "partition_cost", "pattern_hash", "rank_formats",
    "PartitionTuneResult", "TuneResult", "autotune", "autotune_partition",
    "clear_cache", "tune_cache_info",
]

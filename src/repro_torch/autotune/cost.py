"""Pattern and matrix hashes — the subset of ``repro.autotune.cost`` the
port needs so far (the byte-model ranking waits for the autotuner's port).
The hashes equal the JAX package's for the same matrix."""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from ..core.matrices import SparseCSR


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

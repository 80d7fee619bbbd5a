"""Preprocessing work counters.

Every host-side structure pass (partitioning, EHYB build, staircase packing,
ER grouping), every value-only refill (``ehyb_refill``) and every kernel
build and library load (``kernels.nvcc``, ``kernels.load``) increments a
named counter here, so tests and benchmarks can assert *which* work a code
path triggered — in particular, that ``update_values``/refill paths run
zero partitioning or packing passes and build nothing (the amortization
claim of the paper's §6, made checkable).
"""

from __future__ import annotations

from collections import Counter

COUNTERS: Counter = Counter()


def bump(name: str, n: int = 1) -> None:
    COUNTERS[name] += n


def snapshot() -> dict:
    return dict(COUNTERS)


def reset() -> None:
    COUNTERS.clear()

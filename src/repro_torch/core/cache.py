"""Bounded LRU mapping for the framework's memo caches.

Operators, preconditioners and host-side format builds are keyed by a
value-inclusive matrix hash; workloads that update values every step
(transient FEM — the paper's own target) would grow an unbounded dict by one
device-resident entry per step.  Every memo cache in the framework is a
``BoundedCache`` so the steady-state footprint is a fixed number of recently
used matrices.
"""

from __future__ import annotations

from collections import OrderedDict


class BoundedCache:
    """Minimal LRU dict: get/__contains__ refresh recency, insert evicts."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            return default

    def __contains__(self, key) -> bool:
        if key in self._d:
            self._d.move_to_end(key)
            return True
        return False

    def __getitem__(self, key):
        self._d.move_to_end(key)
        return self._d[key]

    def __setitem__(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()

    def keys(self):
        return self._d.keys()

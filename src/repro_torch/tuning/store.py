"""The persistent on-disk tune/plan store (OSKI's offline-tuning lifecycle).

The port of ``repro.tuning.store``.  ``PlanCache`` is in memory, so
without this module every process pays partitioning and tuning once per
*process* instead of once *ever*.  This is the disk tier underneath it: a
directory of versioned JSON metadata files with npz array siblings, one
entry per

    (sparsity-pattern hash, backend, dtype, workload context, k, n_dev, mode)

holding everything a cold process needs to reach a bound operator with
zero partitioning and zero tuner measurements: the chosen format, the
resolved partition strategy *and its arrays* (``part_vec``/``perm``/
``inv_perm`` — ``build_ehyb(m, part=...)`` skips ``make_partition``), the
tuned kernel parameters, and plan metadata.  Per-backend calibration
models (:mod:`repro_torch.tuning.calibration`) live beside them.

Four things differ from the reference:

* **the backend key** (:func:`backend_key`) is ``cpu`` for a CPU plan and
  names the card and its compute capability for a card plan
  (``cuda-NVIDIA_H100_80GB_HBM3-sm90``): the card's geometry and the
  measured times belong to that card;
* **the environment variable** is the port's own (:data:`ENV_VAR`), so the
  two packages never share a directory in which both write ``cpu``
  entries;
* **the key holds the tuner's mode**: a measured decision and a modeled
  one of the same pattern are two entries (the reference keeps one, so a
  ``mode="measure"`` plan after a default one takes the default's
  decision and measures nothing);
* **a partition's geometry is checked**: on the card ``(n_parts,
  vec_size)`` comes from the card's shared memory and SM count
  (``api.plan.partition_sizing``), so a loaded partition of another
  geometry is inconsistent and quarantined, by the reference's own rule
  for inconsistent partition arrays.

Hygiene rules, each counter-tracked and test-pinned:

* **chaos refusal** — nothing measured or decided while
  ``reliability.chaos`` is armed may be persisted;
* **corruption quarantine** — an unreadable/inconsistent entry is renamed
  to ``*.bad`` and treated as a miss, never a crash;
* **stale eviction** — a version from another store generation is deleted
  on sight (there is no migration path for a cache).

Activation: the store participates when the :data:`ENV_VAR` environment
variable names a directory, or when a :class:`TuneStore` is installed with
:func:`set_store`; without either, the framework touches no disk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import re
import time
import warnings
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.counters import bump
from ..core.partition import Partition
from .params import TunedParams

#: Store schema generation.  Bump on any layout/field change: old entries
#: are *evicted*, not migrated — this is a cache, the source of truth is
#: the matrix itself.
STORE_VERSION = 1

ENV_VAR = "REPRO_TORCH_TUNE_CACHE"


def _library_version() -> str:
    from .. import __version__

    return __version__


def backend_key(device) -> str:
    """The store's backend key of ``device`` (a ``torch.device``): ``cpu``,
    or ``cuda-<card name>-sm<major><minor>`` with every run of characters
    other than letters, digits, ``.`` and ``_`` in the name made one
    ``_`` (file-system safe)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    name = re.sub(r"[^A-Za-z0-9_.]+", "_",
                  torch.cuda.get_device_name(device)).strip("_")
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda-{name}-sm{major}{minor}"


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the reference's dtype names)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class TuneEntry:
    """One persisted tuning decision (the JSON payload; arrays ride in the
    sibling npz)."""

    pattern: str                      # sparsity-pattern hash
    backend: str                      # backend_key(plan device)
    dtype: str                        # value dtype name
    context: str                      # workload the ranking priced
    k: int                            # rhs batch width planned for
    n_dev: int                        # mesh size (1 = local)
    format: str                       # winning format
    partition_method: Optional[str]   # resolved strategy (None: no EHYB)
    tuned: Dict[str, int]             # TunedParams payload
    meta: dict = dataclasses.field(default_factory=dict)
    mode: str = "model"               # the tuner's mode ("model"|"measure")
    version: int = STORE_VERSION
    library: str = dataclasses.field(default_factory=_library_version)
    created: float = 0.0

    def key(self) -> str:
        return entry_key(self.pattern, self.backend, self.dtype,
                         self.context, self.k, self.n_dev, self.mode)

    def tuned_params(self) -> TunedParams:
        return TunedParams.from_dict(self.tuned)


def entry_key(pattern: str, backend: str, dtype: str, context: str,
              k: int = 1, n_dev: int = 1, mode: str = "model") -> str:
    """Filesystem-safe store key (one file pair per key)."""
    return f"{pattern}-{backend}-{dtype}-{context}-k{k}-d{n_dev}-{mode}"


class TuneStore:
    """Directory-backed store with hit/miss/stale/quarantine accounting.

    All mutating operations are atomic at the file level (write-to-temp +
    rename), so a crashed writer leaves at worst a ``*.tmp`` orphan, never
    a half-entry a reader could trust.
    """

    def __init__(self, root=None):
        root = root or os.environ.get(ENV_VAR)
        if not root:
            raise ValueError(
                f"TuneStore needs a cache directory: pass root= or set "
                f"${ENV_VAR}")
        self.root = pathlib.Path(root).expanduser()
        self.root.mkdir(parents=True, exist_ok=True)
        self.counters: Counter = Counter()

    # -- paths -------------------------------------------------------------

    def _json_path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.json"

    def _npz_path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.npz"

    def _bump(self, what: str, n: int = 1) -> None:
        self.counters[what] += n
        bump(f"tune_store.{what}", n)

    def _quarantine(self, key: str, reason: str) -> None:
        """Rename a corrupt entry's files to ``*.bad`` — out of the lookup
        path but preserved for post-mortem — and count it."""
        for p in (self._json_path(key), self._npz_path(key)):
            if p.exists():
                try:
                    p.replace(p.with_suffix(p.suffix + ".bad"))
                except OSError:
                    # a locked/vanished file must not turn a cache miss
                    # into a crash; unlinking covers what it can
                    with contextlib.suppress(OSError):
                        p.unlink()
        self._bump("quarantined")
        warnings.warn(f"tune store: quarantined corrupt entry {key!r} "
                      f"({reason})", stacklevel=3)

    def _evict_stale(self, key: str) -> None:
        for p in (self._json_path(key), self._npz_path(key)):
            p.unlink(missing_ok=True)
        self._bump("stale")

    # -- save --------------------------------------------------------------

    def save(self, entry: TuneEntry,
             partition: Optional[Partition] = None) -> bool:
        """Persist ``entry`` (and its partition arrays).  Returns False —
        with a ``refused_chaos`` count — when fault injection is active:
        a decision measured under chaos must never outlive the process."""
        from ..reliability.chaos import active as _chaos_active

        if _chaos_active() is not None:
            self._bump("refused_chaos")
            return False
        entry = dataclasses.replace(entry, created=entry.created or
                                    time.time())
        key = entry.key()
        if partition is not None:
            npz_tmp = self._npz_path(key).with_suffix(".npz.tmp")
            with open(npz_tmp, "wb") as f:      # np.savez(path) would
                # append a second ".npz" to the tmp name; a handle keeps
                # the atomic-rename pair intact
                np.savez(f,
                         part_vec=np.asarray(partition.part_vec, np.int32),
                         perm=np.asarray(partition.perm, np.int64),
                         inv_perm=np.asarray(partition.inv_perm, np.int64),
                         shape=np.asarray([partition.n, partition.n_pad,
                                           partition.n_parts,
                                           partition.vec_size], np.int64))
            npz_tmp.replace(self._npz_path(key))
        tmp = self._json_path(key).with_suffix(".json.tmp")
        tmp.write_text(json.dumps(dataclasses.asdict(entry), indent=1,
                                  sort_keys=True))
        tmp.replace(self._json_path(key))
        self._bump("saved")
        return True

    # -- load --------------------------------------------------------------

    def load(self, pattern: str, backend: str, dtype: str, context: str,
             k: int = 1, n_dev: int = 1, mode: str = "model",
             geometry: Optional[Tuple[int, int]] = None
             ) -> Optional[Tuple[TuneEntry, Optional[Partition]]]:
        """Look up one decision; a hit returns ``(entry, partition)`` with
        the partition reconstructed from the npz (or ``None`` when the
        entry carries no partition).  ``geometry`` is the ``(n_parts,
        vec_size)`` the caller builds at: a stored partition of another
        geometry is inconsistent and quarantined."""
        key = entry_key(pattern, backend, dtype, context, k, n_dev, mode)
        jp = self._json_path(key)
        if not jp.exists():
            self._bump("miss")
            return None
        try:
            raw = json.loads(jp.read_text())
            missing = [f for f in ("pattern", "format", "tuned")
                       if f not in raw]
            if missing:
                raise ValueError(f"missing fields {missing}")
            entry = TuneEntry(**{f.name: raw[f.name]
                                 for f in dataclasses.fields(TuneEntry)
                                 if f.name in raw})
            entry.tuned_params()          # bounds-validate the payload
        except Exception as e:  # noqa: BLE001 — ANY unreadable/invalid
            # payload (truncated JSON, missing fields, out-of-bounds tuned
            # values) is corruption by definition here: quarantine + miss
            self._quarantine(key, f"{type(e).__name__}: {e}")
            return None
        if entry.version != STORE_VERSION:
            self._evict_stale(key)
            return None
        part = None
        npz = self._npz_path(key)
        if npz.exists():
            try:
                with np.load(npz) as z:
                    n, n_pad, n_parts, vec_size = (int(v)
                                                   for v in z["shape"])
                    part = Partition(
                        n=n, n_pad=n_pad, n_parts=n_parts,
                        vec_size=vec_size,
                        part_vec=np.asarray(z["part_vec"], np.int32),
                        perm=np.asarray(z["perm"], np.int64),
                        inv_perm=np.asarray(z["inv_perm"], np.int64),
                        method=entry.partition_method or "")
                if (part.part_vec.shape != (n,)
                        or part.perm.shape != (n_pad,)
                        or part.inv_perm.shape != (n_pad,)
                        or n_pad != n_parts * vec_size
                        or not np.array_equal(
                            np.sort(part.perm), np.arange(n_pad))):
                    raise ValueError("partition arrays inconsistent")
                if geometry is not None and \
                        (n_parts, vec_size) != tuple(geometry):
                    raise ValueError(
                        f"partition geometry {(n_parts, vec_size)} != the "
                        f"plan's {tuple(geometry)}")
            except Exception as e:  # noqa: BLE001 — same rule as the JSON
                # side: an undecodable/inconsistent npz is corruption and
                # must quarantine the whole entry, not crash planning
                self._quarantine(key, f"{type(e).__name__}: {e}")
                return None
        self._bump("hit")
        return entry, part

    # -- eviction / bookkeeping --------------------------------------------

    def evict(self, pattern: Optional[str] = None) -> int:
        """Delete entries (all, or those of one pattern hash); returns the
        number of entries removed."""
        n = 0
        for jp in sorted(self.root.glob("*.json")):
            if pattern is not None and not jp.stem.startswith(pattern):
                continue
            jp.unlink(missing_ok=True)
            self._npz_path(jp.stem).unlink(missing_ok=True)
            n += 1
        self._bump("evicted", n)
        return n

    def entries(self) -> list:
        """Keys currently on disk (calibration files excluded)."""
        return sorted(p.stem for p in self.root.glob("*.json")
                      if not p.stem.startswith("calibration-"))

    def stats(self) -> dict:
        return {"root": str(self.root), "entries": len(self.entries()),
                **{k: self.counters.get(k, 0)
                   for k in ("hit", "miss", "stale", "quarantined",
                             "saved", "evicted", "refused_chaos")}}

    # -- calibration models (per backend) ----------------------------------

    def _calib_path(self, backend: str) -> pathlib.Path:
        return self.root / f"calibration-{backend}.json"

    def save_calibration(self, payload: dict, backend: str) -> bool:
        from ..reliability.chaos import active as _chaos_active

        if _chaos_active() is not None:
            self._bump("refused_chaos")
            return False
        payload = {**payload, "version": STORE_VERSION,
                   "library": _library_version()}
        tmp = self._calib_path(backend).with_suffix(".json.tmp")
        tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
        tmp.replace(self._calib_path(backend))
        self._bump("saved")
        return True

    def load_calibration(self, backend: str) -> Optional[dict]:
        p = self._calib_path(backend)
        if not p.exists():
            return None
        try:
            payload = json.loads(p.read_text())
            if not isinstance(payload.get("coef"), dict):
                raise ValueError("missing coefficient table")
        except Exception as e:  # noqa: BLE001 — corrupt calibration files
            # quarantine exactly like tune entries (miss, never a crash)
            self._quarantine(f"calibration-{backend}",
                             f"{type(e).__name__}: {e}")
            return None
        if payload.get("version") != STORE_VERSION:
            self._evict_stale(f"calibration-{backend}")
            return None
        return payload


# ---------------------------------------------------------------------------
# the process-wide store handle
# ---------------------------------------------------------------------------

_UNSET = object()
_EXPLICIT = _UNSET            # set_store() override (None = disabled)
_ENV_STORES: Dict[str, TuneStore] = {}


def set_store(store) -> Optional[TuneStore]:
    """Install the process-wide store: a :class:`TuneStore`, a path (a new
    store is created there), or ``None`` to disable persistence regardless
    of the environment."""
    global _EXPLICIT
    if store is None or isinstance(store, TuneStore):
        _EXPLICIT = store
    else:
        _EXPLICIT = TuneStore(store)
    return _EXPLICIT


def clear_store() -> None:
    """Forget the explicit override; ``get_store`` re-reads the env var."""
    global _EXPLICIT
    _EXPLICIT = _UNSET


def get_store() -> Optional[TuneStore]:
    """The active store: the :func:`set_store` override when installed,
    else one memoized per ``$REPRO_TORCH_TUNE_CACHE`` value, else ``None``
    (persistence off)."""
    if _EXPLICIT is not _UNSET:
        return _EXPLICIT
    root = os.environ.get(ENV_VAR)
    if not root:
        return None
    st = _ENV_STORES.get(root)
    if st is None:
        st = _ENV_STORES[root] = TuneStore(root)
    return st

"""Measurement-fit calibration: from modeled bytes to predicted seconds.

The port of ``repro.tuning.calibration``.  The autotuner's cost model
(``autotune/cost.py``) ranks formats by *modeled bytes* — a
machine-independent quantity that prices every byte the same: an ELL value
stream, a gathered x read and a permutation round trip all cost "one
byte", and a format's fixed dispatch overhead (launches, scatter setup)
costs nothing.  On a card those weights differ, and for small matrices
the dispatch floor — not bandwidth — decides the race.

This module closes the loop, OSKI-style (measure once per machine,
amortize forever):

1. **measure** (:func:`measure_suite`) — time every eligible format on a
   calibration suite with the tuner's ``_time_spmv`` (CUDA events on a
   card, the host clock on the CPU), and record beside each timing the
   cost model's per-term byte split (``cost.estimate_terms``) and, as a
   cross-check column (never a fit input), the bytes one apply's ops
   read and write (``hlo_bytes``: ``roofline.op_cost``'s count, the
   port's stand-in for the reference's HLO bytes).  A dispatch mode sees
   every aten op but not a hand-written kernel launched through ctypes,
   so a format whose applies launch one (``kernel="cuda"``) keeps None;
2. **fit** (:func:`fit`) — least-squares a per-term *effective time per
   byte* plus a per-format *dispatch intercept* (seconds), clamped
   non-negative;
3. **predict** (:meth:`CalibrationModel.predict`) — modeled term bytes ->
   calibrated seconds.  When a model is installed (:func:`set_model`, or
   loaded from the persistent store for the plan's backend), ``autotune``
   ranks candidates by these predicted seconds and folds the model's
   fingerprint into its cache key;
4. **evaluate** (:func:`evaluate`) — per-matrix agreement of the raw-bytes
   argmin and the calibrated argmin with the measured-fastest format, plus
   the modeled-vs-measured ratio spread.

Like the tune store, the active model is process-global tri-state: an
explicit :func:`set_model` wins, else the persistent store's calibration
for the backend asked for (``store.backend_key`` of the plan's device),
else ``None`` (raw-bytes ranking).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CALIBRATION_VERSION = 1

#: Default calibration suite: one representative per structural category of
#: ``core.matrices.SUITE`` (the full suite is available via ``names=...``).
DEFAULT_SUITE: Tuple[str, ...] = (
    "poisson3d_16", "poisson27_12", "elasticity_8",
    "unstruct_4k", "powerlaw_4k", "rmat_4k", "circuit_4k",
)


@dataclasses.dataclass(frozen=True)
class CalibrationModel:
    """A fitted bytes->seconds model for one backend.

    ``coef`` maps each ``cost.TERMS`` entry to an effective *seconds per
    byte* for that traffic kind; ``intercept`` maps each format name to its
    fixed per-call overhead in seconds (dispatch, launch, scatter setup).
    Both are non-negative by construction (:func:`fit` clamps).
    """

    backend: str
    coef: Dict[str, float]               # term -> s/byte
    intercept: Dict[str, float]          # format -> s (dispatch floor)
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_samples: int = 0
    version: int = CALIBRATION_VERSION

    def predict(self, terms: Dict[str, int], fmt: str) -> float:
        """Calibrated seconds for one apply given its per-term byte split."""
        base = self.intercept.get(fmt, self._default_intercept())
        return base + sum(self.coef.get(t, 0.0) * float(b)
                          for t, b in terms.items())

    def _default_intercept(self) -> float:
        """Formats unseen at fit time get the median dispatch floor — a
        neutral guess that neither hands them a free win nor buries them."""
        vals = sorted(self.intercept.values())
        return float(np.median(vals)) if vals else 0.0

    def fingerprint(self) -> str:
        """Short stable hash of the fitted payload — joins the autotune
        cache key so refreshing a calibration invalidates prior rankings."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    # -- persistence ---------------------------------------------------------

    def to_dict(self) -> dict:
        return {"backend": self.backend,
                "coef": {k: float(v) for k, v in sorted(self.coef.items())},
                "intercept": {k: float(v)
                              for k, v in sorted(self.intercept.items())},
                "stats": {k: float(v) for k, v in sorted(self.stats.items())},
                "n_samples": int(self.n_samples),
                "version": int(self.version)}

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationModel":
        if int(d.get("version", -1)) != CALIBRATION_VERSION:
            raise ValueError(
                f"calibration payload version {d.get('version')!r} != "
                f"{CALIBRATION_VERSION}")
        return cls(backend=str(d["backend"]),
                   coef={str(k): float(v) for k, v in d["coef"].items()},
                   intercept={str(k): float(v)
                              for k, v in d["intercept"].items()},
                   stats={str(k): float(v)
                          for k, v in d.get("stats", {}).items()},
                   n_samples=int(d.get("n_samples", 0)),
                   version=CALIBRATION_VERSION)


def _backend(device=None) -> str:
    """The store's backend key of ``device`` (default ``cuda``; raises
    without a card, as every entry point does)."""
    from ..api.plan import resolve_device
    from .store import backend_key

    return backend_key(resolve_device(device))


# ---------------------------------------------------------------------------
# active-model registry (tri-state, mirrors tuning.store.get_store)
# ---------------------------------------------------------------------------

_UNSET = object()
_EXPLICIT = _UNSET                      # set_model() override, if any
_STORE_MODELS: Dict[tuple, Optional[CalibrationModel]] = {}


def set_model(model: Optional[CalibrationModel]) -> None:
    """Install ``model`` as the active calibration (``None`` disables
    calibrated ranking even if the store holds one)."""
    global _EXPLICIT
    _EXPLICIT = model


def clear_model() -> None:
    """Forget the explicit override and the per-store memo — the next
    :func:`get_model` re-resolves from the persistent store."""
    global _EXPLICIT
    _EXPLICIT = _UNSET
    _STORE_MODELS.clear()


def get_model(backend: Optional[str] = None) -> Optional[CalibrationModel]:
    """The active calibration model for ``backend`` (a
    ``store.backend_key``; default: the default device's), or ``None``
    when ranking should stay raw-bytes."""
    if _EXPLICIT is not _UNSET:
        return _EXPLICIT
    from .store import get_store

    st = get_store()
    if st is None:
        return None
    backend = backend or _backend()
    memo_key = (str(st.root), backend)
    if memo_key not in _STORE_MODELS:
        payload = st.load_calibration(backend)
        model = None
        if payload is not None:
            try:
                model = CalibrationModel.from_dict(payload)
            except Exception:    # noqa: BLE001 — a malformed stored payload
                # degrades to raw-bytes ranking; the store already
                # quarantined/evicted what it could
                model = None
        _STORE_MODELS[memo_key] = model
    return _STORE_MODELS[memo_key]


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def measure_suite(names: Optional[Sequence[str]] = None, dtype=None, *,
                  formats: Optional[Sequence[str]] = None,
                  context: str = "spmv", k: int = 1,
                  device=None) -> List[dict]:
    """Time every eligible format on the calibration suite on ``device``
    (default ``cuda``).

    Returns one sample dict per (matrix, format): ``matrix``, ``format``,
    ``measured_s``, ``terms`` (per-``cost.TERMS`` byte split),
    ``modeled_bytes`` (their sum) and ``hlo_bytes`` (one apply's op
    bytes, None for a format that launches hand-written kernels: see the
    module docstring).  The EHYB family shares one host build per matrix, on bfs
    partitions at the geometry a plan on ``device`` builds
    (``api.plan.partition_sizing``).  On the CPU the formats whose applies
    launch CUDA kernels (``kernel="cuda"``) are skipped — their CPU
    timings say nothing about the card, the reason the reference skips
    its interpreted kernels; on a card they are measured too
    (``ehyb_packed`` launches #2 at k = 1 and #8 at k ≥ 2).  A format
    that fails is skipped with a warning on the CPU; on a card only an
    injected fault skips it (the tuner's rule), any other failure
    raises.
    """
    import torch

    from ..api.plan import PLAN_CACHE, partition_sizing, resolve_device
    from ..autotune.cost import estimate_terms, matrix_stats, pattern_hash
    from ..autotune.registry import available_formats, get_format
    from ..autotune.tuner import _time_spmv
    from ..core.matrices import SUITE
    from ..reliability.chaos import ChaosFault
    from ..reliability.chaos import check_kernel as _chaos_check
    from ..reliability.policy import ReliabilityWarning

    device = resolve_device(device)
    dtype = dtype or torch.float32
    val_bytes = torch.empty((), dtype=dtype).element_size()
    on_cpu = device.type == "cpu"
    names = tuple(names or DEFAULT_SUITE)
    fmts = tuple(formats or available_formats())
    rng = np.random.default_rng(7)
    samples: List[dict] = []
    for name in names:
        if name not in SUITE:
            raise KeyError(f"unknown suite matrix {name!r}; "
                           f"have {sorted(SUITE)}")
        m = SUITE[name]()
        stats = matrix_stats(m)
        key = pattern_hash(m)
        part = PLAN_CACHE.partition(m, key, "bfs",
                                    *partition_sizing(m.n, device, k))
        shared = {"ehyb": PLAN_CACHE.host_ehyb(m, key, part)}
        shape = (m.n,) if k == 1 else (m.n, k)
        x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                            device=device)
        for f in fmts:
            spec = get_format(f)
            if on_cpu and spec.kernel == "cuda":
                continue
            try:
                _chaos_check(f"tune:{f}")
                terms = estimate_terms(m, f, val_bytes, shared, stats,
                                       context, k)
                obj = spec.build(m, shared, dtype, device)
                t = _time_spmv(spec.apply, obj, x)
            except Exception as e:    # noqa: BLE001 — re-raised on a card
                # unless injected; elsewhere the format contributes no
                # sample
                if not on_cpu and not isinstance(e, ChaosFault):
                    raise
                warnings.warn(
                    f"calibration: {f!r} on {name!r} failed "
                    f"({type(e).__name__}: {e}); skipping",
                    ReliabilityWarning, stacklevel=2)
                continue
            samples.append({
                "matrix": name, "format": f, "measured_s": float(t),
                "terms": {tk: int(tv) for tk, tv in terms.items()},
                "modeled_bytes": int(sum(terms.values())),
                "hlo_bytes": (None if spec.kernel == "cuda"
                              else _op_bytes(spec.apply, obj, x)),
            })
    return samples


def _op_bytes(apply, obj, x) -> float:
    """Bytes the ops of one ``apply(obj, x)`` read and write
    (``roofline.op_cost``'s upper count: operands plus results of every
    op but views and allocations)."""
    from ..roofline.op_cost import count

    return float(count(apply, obj, x, hold=(x,))["bytes"])


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def fit(samples: Sequence[dict], backend: Optional[str] = None
        ) -> CalibrationModel:
    """Least-squares per-term s/byte coefficients + per-format intercepts.

    The design matrix has one column per ``cost.TERMS`` entry (the sample's
    byte count for that traffic kind) and one indicator column per format
    (its dispatch intercept).  The solve is weighted by ``1/measured_s`` —
    relative error, not absolute — because the model's job is *ranking*:
    an unweighted fit lets the suite's slowest matrices swallow the
    residual budget.  After the joint solve, negative term coefficients
    are clamped to zero (a sparse design can otherwise trade a negative
    bandwidth against an inflated intercept) and the intercepts are
    re-derived as each format's ``1/y²``-weighted mean residual, clamped
    non-negative.  ``backend`` labels the model (default: the default
    device's ``store.backend_key``).
    """
    from ..autotune.cost import TERMS

    if not samples:
        raise ValueError("cannot fit a calibration from zero samples")
    backend = backend or _backend()
    fmts = sorted({s["format"] for s in samples})
    n, nt = len(samples), len(TERMS)
    A = np.zeros((n, nt + len(fmts)))
    y = np.zeros(n)
    for i, s in enumerate(samples):
        for j, t in enumerate(TERMS):
            A[i, j] = float(s["terms"].get(t, 0))
        A[i, nt + fmts.index(s["format"])] = 1.0
        y[i] = float(s["measured_s"])
    # scale byte columns to O(1) so lstsq conditioning doesn't mix 1e8-byte
    # streams with 0/1 indicators
    scale = np.maximum(np.abs(A[:, :nt]).max(axis=0), 1.0)
    A[:, :nt] /= scale
    # relative-error weighting: minimize sum((pred_i - y_i) / y_i)^2
    w = 1.0 / np.maximum(y, 1e-12)
    sol = np.linalg.lstsq(A * w[:, None], y * w, rcond=None)[0]
    coef = {t: max(float(sol[j] / scale[j]), 0.0)
            for j, t in enumerate(TERMS)}
    # re-derive intercepts against the clamped slopes (same 1/y^2 weights)
    resid = y - np.array([
        sum(coef[t] * float(s["terms"].get(t, 0)) for t in TERMS)
        for s in samples])
    intercept = {}
    for jf, f in enumerate(fmts):
        mask = A[:, nt + jf] > 0.5
        wf = w[mask] ** 2
        intercept[f] = max(float((resid[mask] * wf).sum() / wf.sum()), 0.0)
    pred = np.array([
        intercept[s["format"]] + sum(coef[t] * float(s["terms"].get(t, 0))
                                     for t in TERMS) for s in samples])
    ratio = pred / np.maximum(y, 1e-12)
    stats = {"ratio_min": float(ratio.min()),
             "ratio_max": float(ratio.max()),
             "ratio_geomean": float(np.exp(np.mean(np.log(
                 np.maximum(ratio, 1e-12))))),
             "r2": float(1.0 - ((pred - y) ** 2).sum()
                         / max(((y - y.mean()) ** 2).sum(), 1e-24))}
    return CalibrationModel(backend=backend, coef=coef, intercept=intercept,
                            stats=stats, n_samples=n)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def evaluate(samples: Sequence[dict], model: CalibrationModel) -> dict:
    """Per-matrix winner agreement + prediction-ratio spread.

    For every suite matrix with >= 2 timed formats, compares the
    measured-fastest format against (a) the raw modeled-bytes argmin and
    (b) the calibrated predicted-seconds argmin.
    """
    by_matrix: Dict[str, List[dict]] = {}
    for s in samples:
        by_matrix.setdefault(s["matrix"], []).append(s)
    rows, agree_raw, agree_cal, contested = [], 0, 0, 0
    ratios = []
    for name, group in sorted(by_matrix.items()):
        pred = {g["format"]: model.predict(g["terms"], g["format"])
                for g in group}
        meas = {g["format"]: g["measured_s"] for g in group}
        raw = {g["format"]: g["modeled_bytes"] for g in group}
        for g in group:
            ratios.append(pred[g["format"]] / max(meas[g["format"]], 1e-12))
        w_meas = min(sorted(meas), key=meas.get)
        w_raw = min(sorted(raw), key=raw.get)
        w_cal = min(sorted(pred), key=pred.get)
        rows.append({"matrix": name, "measured_winner": w_meas,
                     "raw_winner": w_raw, "calibrated_winner": w_cal,
                     "measured_s": meas, "predicted_s": pred})
        if len(group) >= 2:
            contested += 1
            agree_raw += int(w_raw == w_meas)
            agree_cal += int(w_cal == w_meas)
    ratios_a = np.asarray(ratios) if ratios else np.asarray([1.0])
    return {"matrices": rows, "contested": contested,
            "agree_raw": agree_raw, "agree_calibrated": agree_cal,
            "ratio_geomean": float(np.exp(np.mean(np.log(
                np.maximum(ratios_a, 1e-12))))),
            "ratio_min": float(ratios_a.min()),
            "ratio_max": float(ratios_a.max())}


# ---------------------------------------------------------------------------
# the one-call runner
# ---------------------------------------------------------------------------

def calibrate(names: Optional[Sequence[str]] = None, dtype=None, *,
              formats: Optional[Sequence[str]] = None,
              context: str = "spmv", k: int = 1, persist: bool = True,
              install: bool = True, device=None) -> dict:
    """Measure → fit → evaluate → (persist, install) on ``device`` (default
    ``cuda``).  Returns a report dict: ``model`` (payload),
    ``evaluation``, ``samples``, ``persisted``.

    ``persist`` saves the fitted payload into the active tune store under
    the device's backend key (no-op without one, refused under chaos);
    ``install`` makes it the active model for this process so subsequent
    ``autotune`` calls rank by calibrated seconds immediately.
    """
    from ..api.plan import resolve_device
    from .store import backend_key, get_store

    device = resolve_device(device)
    samples = measure_suite(names, dtype, formats=formats, context=context,
                            k=k, device=device)
    model = fit(samples, backend=backend_key(device))
    ev = evaluate(samples, model)
    persisted = False
    if persist:
        st = get_store()
        if st is not None:
            persisted = st.save_calibration(model.to_dict(), model.backend)
            _STORE_MODELS.pop((str(st.root), model.backend), None)
    if install:
        set_model(model)
    return {"model": model.to_dict(), "evaluation": ev,
            "samples": samples, "persisted": persisted}


def report(model: Optional[CalibrationModel] = None, device=None) -> str:
    """Human-readable calibration table (``python -m repro_torch.tuning
    --report``): ``model``, else the active model for ``device``'s
    backend."""
    model = model if model is not None else get_model(_backend(device))
    if model is None:
        return ("no calibration model active "
                "(set REPRO_TORCH_TUNE_CACHE and run --calibrate)")
    lines = [f"calibration [{model.backend}] "
             f"fingerprint={model.fingerprint()} "
             f"n_samples={model.n_samples}",
             "  term coefficients (effective s/byte -> GB/s):"]
    for t, c in sorted(model.coef.items()):
        bw = (1.0 / c / 1e9) if c > 0 else float("inf")
        lines.append(f"    {t:<14} {c:.3e} s/B   ({bw:8.2f} GB/s eff)")
    lines.append("  per-format dispatch intercepts:")
    for f, b in sorted(model.intercept.items()):
        lines.append(f"    {f:<16} {b * 1e6:10.2f} us")
    if model.stats:
        lines.append("  fit: " + "  ".join(
            f"{k}={v:.4g}" for k, v in sorted(model.stats.items())))
    return "\n".join(lines)

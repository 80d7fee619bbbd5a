"""The autotuner: model-ranked, optionally measured, pattern-hash cached.

The port of ``repro.autotune.tuner``.  ``autotune(A)`` is OSKI's tuning
loop:

1. **cost-model pass** — rank every registered format by modeled bytes
   (``cost.rank_formats``; one shared host EHYB build serves the family),
   or, when a calibration model is active for the plan's backend
   (:func:`repro_torch.tuning.calibration.get_model`), by its predicted
   seconds (``TuneResult.calibrated_s``);
2. **measured pass** (``mode="measure"``) — build the ``top_k``
   model-ranked eligible candidates on the plan's device and time their
   applies (CUDA events on a card, ``perf_counter`` on the CPU), picking
   the fastest, then sweep the winner's tunable parameters
   (:func:`repro_torch.tuning.sweep_grid`);
3. **cache** — the decision is memoized under (pattern hash, dtype, mode,
   candidate set, context, k, tuned pin, sweep, device type, the
   partition the family's models priced and the calibration model's
   fingerprint): re-tuning the same pattern is a dict lookup.  (The
   reference's key has no partition, so a pattern planned on two
   partitions shares one decision there.)  The persistent store
   (``tuning.store``) sits above this memo, in ``api.plan``.

Eligibility follows the plan's device: a CPU plan never selects a format
whose applies launch CUDA kernels (``kernel="cuda"``), as the reference
never selects an interpreter-backed kernel on the CPU; a card plan may
select any.  A card plan also never selects a format whose modeled bytes
for one apply (its tables and vectors, each read once) exceed the card's
memory (:func:`_device_capacity`): the dense format of a large pattern
would otherwise win under a calibration that fitted its stream's traffic
kind as free, and its build would ask for terabytes.  A measured candidate that fails is skipped with a
:class:`~repro_torch.reliability.ReliabilityWarning` and the
``tune.candidate_failed`` counter on a CPU plan; on a card plan only an
injected :class:`~repro_torch.reliability.chaos.ChaosFault` skips it, and
any other failure is raised, so no kernel failure hides behind a plain
format (the guard's rule, ``reliability.guard``).

:func:`autotune_partition` prices every registered partition strategy with
``cost.partition_cost`` at the geometry the plan builds
(``api.plan.partition_sizing``), its partitions taken from the plan
cache, so a plan pinned to the winner shares the partition pass.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..core.cache import BoundedCache
from ..core.counters import bump
from ..core.matrices import SparseCSR
from ..reliability.chaos import ChaosFault
from ..reliability.chaos import active as _chaos_active
from ..reliability.chaos import check_kernel as _chaos_check
from ..reliability.policy import ReliabilityWarning
from .cost import CONTEXTS, pattern_hash, rank_formats


@dataclasses.dataclass(frozen=True)
class TuneResult:
    format: str                       # the winner
    key: str                          # sparsity-pattern hash
    mode: str                         # "model" | "measure"
    modeled_bytes: Dict[str, int]     # per-candidate modeled bytes
    measured_s: Optional[Dict[str, float]]  # per-timed-candidate seconds
    context: str = "spmv"             # workload the model ranked for
    # per-candidate calibrated predicted seconds when a calibration model
    # ranked the candidates, else None (ranked on modeled bytes)
    calibrated_s: Optional[Dict[str, float]] = None
    # winning tunable-parameter assignment (TunedParams payload) from the
    # measured sweep, or None when no sweep ran for the winner
    tuned: Optional[Dict[str, int]] = None
    # measured seconds per swept assignment, keyed by TunedParams.token()
    sweep_s: Optional[Dict[tuple, float]] = None


@dataclasses.dataclass(eq=False)
class PartitionTuneResult:
    """``autotune_partition`` outcome: the priced strategy table plus the
    winning :class:`~repro_torch.core.partition.Partition` itself (so the
    caller builds the selected EHYB without re-partitioning)."""

    strategy: str                        # the winner
    key: str                             # sparsity-pattern hash
    context: str                         # workload the model priced for
    n_dev: int                           # mesh size (1 = local)
    modeled_bytes: Dict[str, int]        # per-strategy modeled bytes/SpMV
    in_part_fraction: Dict[str, float]   # per-strategy cached-read share
    halo_words: Dict[str, int]           # per-strategy (dist context only)
    partition: object = dataclasses.field(repr=False, default=None)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


_CACHE = BoundedCache(maxsize=128)    # TuneResults are small host dicts


def clear_cache() -> None:
    """Forget the format decisions (partition decisions live in their plan
    cache, with the partitions they priced: ``PlanCache.clear``)."""
    _CACHE.clear()


def tune_cache_info() -> dict:
    """In-memory tune-cache contents, and under ``disk`` the active
    persistent store's entries and counters (None without a store)."""
    from ..tuning.store import get_store

    st = get_store()
    return {"entries": len(_CACHE),
            "keys": sorted(k[0] for k in _CACHE.keys()),
            "disk": None if st is None else st.stats()}


def _run(fn, inner: int, cuda: bool) -> float:
    """Seconds of one of ``inner`` back-to-back calls of ``fn``: CUDA
    events around the calls on a card, the host clock on the CPU (where
    every op finishes before it returns)."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / inner
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    return (time.perf_counter() - t0) / inner


def _time_spmv(apply, obj, x, repeats: int = 5, warmup: int = 1,
               min_duration_s: float = 1e-3, max_inner: int = 512) -> float:
    """Median seconds of one ``apply(obj, x)`` on x's device.

    After ``warmup`` calls, one timed call (the probe) sizes an inner loop
    so each of the ``repeats`` spans at least ``min_duration_s``: a
    sub-millisecond apply timed alone sits at the clock's noise floor,
    where rankings flip run to run.  Bumps ``tune.measured`` once."""
    bump("tune.measured")
    cuda = x.device.type == "cuda"
    for _ in range(warmup):
        apply(obj, x)
    probe = _run(lambda: apply(obj, x), 1, cuda)   # also one more warmup
    inner = min(max(1, math.ceil(min_duration_s / max(probe, 1e-9))),
                max_inner)
    return float(np.median([_run(lambda: apply(obj, x), inner, cuda)
                            for _ in range(repeats)]))


def _skip(device: torch.device, what: str, err: Exception) -> None:
    """A measured candidate failed: skip it (warned and counted) on a CPU
    plan, or on a card plan when the failure was injected; raise any
    other failure on a card."""
    if device.type == "cuda" and not isinstance(err, ChaosFault):
        raise err
    bump("tune.candidate_failed")
    warnings.warn(f"autotune: {what} failed ({type(err).__name__}: {err}); "
                  f"skipping it", ReliabilityWarning, stacklevel=3)


def _device_capacity(device: torch.device) -> Optional[int]:
    """Bytes of memory a format's tables may take on ``device``: the
    card's total memory, or None (no limit) on the CPU, whose rankings stay
    the reference's."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def _val_bytes(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _partition_key(shared: dict):
    """The partition the family's models price: that of ``shared["ehyb"]``
    (None: the bfs fallback at the reference's geometry)."""
    e = shared.get("ehyb")
    return None if e is None else (e.partition_method, e.n_parts,
                                   e.vec_size)


def autotune(m: SparseCSR, dtype=None, *, mode: str = "model",
             candidates=None, top_k: int = 3, use_cache: bool = True,
             shared: Optional[dict] = None, context: str = "spmv",
             n_dev: int = 1, k: int = 1, tuned=None,
             sweep_params: Optional[bool] = None,
             device=None) -> TuneResult:
    """Select the SpMV format for ``m``; see the module docstring.

    ``shared`` carries the host EHYB build across the cost model, the
    measured pass and the caller's build (one partitioning pass end to
    end).  ``context`` is "spmv" (one-shot original-space call) or
    "solver" (permuted-space hot-loop iteration: the measured pass times
    the permuted-space apply of the formats that have one) or "dist" (one
    iteration sharded over ``n_dev`` devices: the solver bytes plus the
    interconnect term; the measured pass and the sweep are skipped and the
    ranking stays model-driven, since a one-device timing holds none of the
    interconnect traffic this context prices).  ``k`` is the rhs batch
    width the apply will run at.  ``tuned`` pins the tunable parameters of
    every candidate
    build; ``sweep_params`` (default: under ``mode="measure"`` with no pin)
    sweeps the winner's grid and records the fastest assignment in
    ``TuneResult.tuned``.  ``device`` (default ``cuda``) is the plan's: it
    decides which formats are eligible, where the measured pass runs and
    which backend's calibration model (if any) ranks the candidates in
    predicted seconds; the model's fingerprint joins the cache key, so
    installing or refreshing a calibration never serves stale decisions.
    """
    from ..api.plan import resolve_device
    from ..tuning import calibration
    from ..tuning.params import TunedParams, sweep_grid
    from ..tuning.store import backend_key
    from .cost import estimate_terms, matrix_stats
    from .registry import available_formats, get_format

    if mode not in ("model", "measure"):
        raise ValueError(f"mode must be 'model' or 'measure', got {mode!r}")
    if context not in CONTEXTS:
        raise ValueError(f"context must be one of {CONTEXTS}, "
                         f"got {context!r}")
    if context == "dist" and n_dev < 2:
        raise ValueError("context='dist' prices a multi-device mesh; "
                         "pass n_dev >= 2 (a 1-device build is "
                         "context='solver')")
    if not isinstance(k, int) or k < 1:
        raise ValueError(f"k must be a positive int, got {k!r}")
    device = resolve_device(device)
    dtype = dtype or torch.float32
    cand = tuple(candidates or available_formats())
    key = pattern_hash(m)
    shared = {} if shared is None else shared
    cal = calibration.get_model(backend_key(device))
    sweep = ((mode == "measure" and context != "dist" and tuned is None)
             if sweep_params is None else bool(sweep_params))
    cache_key = (key, str(dtype), mode, cand, context,
                 n_dev if context == "dist" else None, k,
                 None if tuned is None else tuned.token(), sweep,
                 device.type, _partition_key(shared),
                 None if cal is None else cal.fingerprint())
    # a ranking decided under fault injection must not outlive it
    use_cache = use_cache and _chaos_active() is None
    if use_cache and cache_key in _CACHE:
        return _CACHE[cache_key]

    if context == "dist":
        shared["n_dev"] = n_dev
    if tuned is not None:
        shared["tuned"] = tuned
    val_bytes = _val_bytes(dtype)
    ranked = rank_formats(m, val_bytes, cand, shared, context, k)
    modeled = dict(ranked)
    cap = _device_capacity(device)
    if cap is not None:
        ranked = [(f, b) for f, b in ranked if b <= cap]
        if not ranked:
            raise ValueError(
                f"no candidate format fits in {cap} bytes on {device}: "
                f"modeled bytes {modeled}")
        cand = tuple(f for f in cand if modeled[f] <= cap)
    calibrated = None
    if cal is not None:
        stats = matrix_stats(m)
        calibrated = {f: cal.predict(estimate_terms(
            m, f, val_bytes, shared, stats, context, k), f) for f in cand}
        ranked = sorted(calibrated.items(), key=lambda kv: (kv[1], kv[0]))
    on_cpu = device.type == "cpu"
    eligible = [f for f, _ in ranked
                if not (on_cpu and get_format(f).kernel == "cuda")]
    winner = (eligible or [ranked[0][0]])[0]
    measured = None

    def timed_apply(spec, obj, rng):
        """Seconds of the apply the context runs, on a random rhs."""
        if context == "solver" and spec.permuted is not None:
            shape = (obj.n_pad,) if k == 1 else (obj.n_pad, k)
            apply = spec.permuted
        else:
            shape = (m.n,) if k == 1 else (m.n, k)
            apply = spec.apply
        x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                            device=device)
        return _time_spmv(apply, obj, x)

    # a "dist" ranking stays model-driven under mode="measure" (see above)
    if mode == "measure" and context != "dist" and eligible[:top_k]:
        rng0 = np.random.default_rng(0)
        measured = {}
        for f in eligible[:top_k]:
            try:
                _chaos_check(f"tune:{f}")
                spec = get_format(f)
                measured[f] = timed_apply(
                    spec, spec.build(m, shared, dtype, device), rng0)
            except Exception as e:  # noqa: BLE001 — _skip re-raises all
                # but what the guard's rule lets a measured pass skip
                _skip(device, f"measured candidate {f!r}", e)
        if measured:
            winner = min(sorted(measured), key=measured.get)

    # ---- tunable-parameter sweep for the winner ---------------------------
    best = tuned
    sweep_s = None
    spec = get_format(winner)
    grid = list(sweep_grid(winner, k=k))
    if sweep and mode == "measure" and context != "dist" and \
            len(grid) > 1 and not (on_cpu and spec.kernel == "cuda"):
        rng1 = np.random.default_rng(1)
        sweep_s = {}
        for params in grid:
            try:
                _chaos_check(f"tune:{winner}:sweep")
                obj = spec.build(m, {**shared, "tuned": params}, dtype,
                                 device)
                sweep_s[params.token()] = timed_apply(spec, obj, rng1)
            except Exception as e:  # noqa: BLE001 — the candidates' rule
                _skip(device, f"swept params {params.to_dict()} for "
                      f"{winner!r}", e)
        if sweep_s:
            best = TunedParams(**dict(min(sorted(sweep_s),
                                          key=sweep_s.get)))

    result = TuneResult(format=winner, key=key, mode=mode,
                        modeled_bytes=modeled, measured_s=measured,
                        context=context, calibrated_s=calibrated,
                        tuned=None if best is None else best.to_dict(),
                        sweep_s=sweep_s)
    if use_cache:
        _CACHE[cache_key] = result
    return result


def autotune_partition(m: SparseCSR, *, candidates=None,
                       context: str = "spmv", n_dev: int = 1,
                       val_bytes: int = 4,
                       geometry: Optional[tuple] = None, cache=None,
                       use_cache: bool = True) -> PartitionTuneResult:
    """Pick the partition strategy the bytes-moved model prefers for ``m``.

    Partitions ``m`` with every registered strategy at ``geometry``
    (``(n_parts, vec_size)``; default the reference's ``choose_vec_size``,
    which a CPU plan builds at) through ``cache``'s partition memo (default
    the module's plan cache), and prices each with
    :func:`~repro_torch.autotune.cost.partition_cost` in ``context`` —
    exactly ELL-width padding + ER spill + the in-partition fraction's x
    and perm traffic, and for ``context="dist"`` the scheduled halo words
    over ``n_dev`` devices (kept per strategy in ``halo_words``).  Ties
    break toward the higher in-partition fraction,
    then the name.  Whenever ``natural`` is a candidate, the winner must
    serve at least as large a share of x-reads from the explicit cache as
    ``natural`` does (the paper's locality metric), which strikes
    partitions whose narrow tiles win on bytes while their cached share
    collapses.  Decisions are cached in ``cache`` beside its partitions,
    per pattern, candidates, context, ``val_bytes`` and geometry;
    ``PartitionTuneResult.seconds`` holds each strategy's partitioning
    seconds."""
    from ..api.plan import PLAN_CACHE
    from ..core.partition import available_strategies, choose_vec_size
    from .cost import partition_cost

    if context not in CONTEXTS:
        raise ValueError(f"unknown context {context!r}; have {CONTEXTS}")
    if context == "dist" and n_dev < 2:
        raise ValueError("context='dist' needs n_dev >= 2")
    cache = PLAN_CACHE if cache is None else cache
    cand = tuple(candidates) if candidates else available_strategies()
    key = pattern_hash(m)
    n_parts, vec_size = geometry or choose_vec_size(m.n)
    cache_key = (key, cand, context, n_dev if context == "dist" else 1,
                 val_bytes, n_parts, vec_size)
    if use_cache and cache_key in cache.partition_tunings:
        return cache.partition_tunings[cache_key]

    modeled: Dict[str, int] = {}
    fracs: Dict[str, float] = {}
    seconds: Dict[str, float] = {}
    halos: Dict[str, int] = {}
    parts = {}
    for name in cand:
        part = cache.partition(m, key, name, n_parts, vec_size)
        cost = partition_cost(m, part, val_bytes, context=context,
                              n_dev=n_dev)
        modeled[name] = cost["total"]
        if context == "dist":
            halos[name] = cost["interconnect"] // (val_bytes or 1)
        fracs[name] = part.in_partition_fraction(m)
        seconds[name] = part.seconds
        parts[name] = part
    # cached-read-share floor (see docstring)
    floor = fracs.get("natural", float("-inf")) - 1e-12
    eligible = [s for s in cand if fracs[s] >= floor] or list(cand)
    winner = min(eligible, key=lambda s: (modeled[s], -fracs[s], s))
    result = PartitionTuneResult(strategy=winner, key=key, context=context,
                                 n_dev=n_dev, modeled_bytes=modeled,
                                 in_part_fraction=fracs, halo_words=halos,
                                 partition=parts[winner], seconds=seconds)
    if use_cache:
        cache.partition_tunings[cache_key] = result
    return result

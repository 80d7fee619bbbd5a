"""Calibrated autotuning: tunable parameters, measurement-fit cost model,
and the persistent on-disk tune/plan store (the port of ``repro.tuning``).

Three layers on top of ``repro_torch.autotune`` (see each module's
docstring):

* :mod:`~repro_torch.tuning.params` — the declared, bounded search space
  for the kernels' tunable constants (``TunedParams`` rides
  ``ExecutionConfig`` into the plan identity);
* :mod:`~repro_torch.tuning.calibration` — fits per-term effective
  bandwidths and per-format dispatch intercepts to measured timings so
  ``autotune`` ranks candidates in predicted *seconds* instead of raw
  modeled bytes;
* :mod:`~repro_torch.tuning.store` — the versioned on-disk store
  (activated by ``REPRO_TORCH_TUNE_CACHE`` or :func:`set_store`) that
  persists tuned decisions, partitions and calibrations per backend, so a
  fresh process reaches a bound operator with zero re-partitioning and
  zero tuner measurements.

``python -m repro_torch.tuning --report`` prints the active calibration;
``--calibrate`` runs the measure→fit→persist loop; ``--stats`` prints the
store's entries and counters.
"""

from .calibration import (DEFAULT_SUITE, CalibrationModel, calibrate,
                          clear_model, evaluate, fit, get_model,
                          measure_suite, report, set_model)
from .params import (DEFAULT_PARAMS, SEARCH_SPACE, ParamSpec, TunedParams,
                     resolve, sweep_grid)
from .store import (ENV_VAR, TuneEntry, TuneStore, backend_key, clear_store,
                    entry_key, get_store, set_store)

__all__ = [
    "ParamSpec", "TunedParams", "SEARCH_SPACE", "DEFAULT_PARAMS",
    "sweep_grid", "resolve",
    "TuneStore", "TuneEntry", "entry_key", "get_store", "set_store",
    "clear_store", "ENV_VAR", "backend_key",
    "CalibrationModel", "calibrate", "measure_suite", "fit", "evaluate",
    "get_model", "set_model", "clear_model", "report", "DEFAULT_SUITE",
]

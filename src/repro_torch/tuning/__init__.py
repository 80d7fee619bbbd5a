"""Tunable kernel parameters (the port of ``repro.tuning.params``; the
persistent store and the calibration model are not ported yet)."""

from .params import (DEFAULT_PARAMS, SEARCH_SPACE, ParamSpec, TunedParams,
                     resolve, sweep_grid)

__all__ = ["DEFAULT_PARAMS", "SEARCH_SPACE", "ParamSpec", "TunedParams",
           "resolve", "sweep_grid"]

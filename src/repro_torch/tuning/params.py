"""Tunable kernel parameters: the declared, bounded search space.

The port of ``repro.tuning.params``.  Two knobs change what the port's
applies do:

* ``rhs_chunk`` — rhs columns per chunk in the SpMM kernels' K loop
  (``kernels.ehyb_spmm``; the packed container carries it to
  ``ehyb_packed_fused_spmm`` and ``ehyb_ell_packed_spmm``, which cut it to
  what a block's shared memory holds);
* ``n_buckets`` — how many width classes the bucketed format splits its
  partition tiles into (``core.ehyb.build_buckets``).

The reference's third knob, ``gather_budget``, is the VMEM byte budget of
its Pallas kernels' W sweep; no CUDA kernel reads it (their lane groups,
unrolls and block sizes are compile-time constants), so the port leaves it
out.  :meth:`TunedParams.from_dict` ignores unknown keys, so a reference
payload still loads.

A :class:`TunedParams` is frozen and hashable; an
:class:`~repro_torch.api.ExecutionConfig` folds its :meth:`~TunedParams.token`
into the plan identity, and :func:`sweep_grid` is the candidate grid the
measured tuner sweeps.  Bounds are validated at construction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

# the widest register accumulator csrc/ehyb_spmm.cu instantiates
# (kernels.ehyb_spmm.MAX_RHS_CHUNK, restated so this module imports no
# kernel wrapper)
_MAX_RHS_CHUNK = 32


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One tunable parameter: default, sweep candidates, hard bounds."""

    name: str
    default: int
    candidates: Tuple[int, ...]       # the measured sweep's grid
    lo: int                           # inclusive hard bounds (validation)
    hi: int
    description: str = ""

    def validate(self, value: int) -> int:
        if not isinstance(value, int) or isinstance(value, bool) or \
                not (self.lo <= value <= self.hi):
            raise ValueError(
                f"tuned parameter {self.name}={value!r} outside its "
                f"declared bounds [{self.lo}, {self.hi}]")
        return value


#: The declared search space: ``candidates`` are what the measured sweep
#: tries, ``lo``/``hi`` the validation envelope.  ``rhs_chunk`` is bounded
#: by the widest accumulator the SpMM kernels are built with.
SEARCH_SPACE: Dict[str, ParamSpec] = {
    "rhs_chunk": ParamSpec(
        "rhs_chunk", default=16, candidates=(8, 16, 32),
        lo=1, hi=_MAX_RHS_CHUNK,
        description="rhs columns per chunk in the SpMM kernels' K loop"),
    "n_buckets": ParamSpec(
        "n_buckets", default=4, candidates=(2, 4, 8),
        lo=1, hi=16,
        description="width classes for the bucketed format's partition "
                    "tiles"),
}


@dataclasses.dataclass(frozen=True)
class TunedParams:
    """A concrete assignment of every tunable kernel parameter (hashable,
    bounded)."""

    rhs_chunk: int = SEARCH_SPACE["rhs_chunk"].default
    n_buckets: int = SEARCH_SPACE["n_buckets"].default

    def __post_init__(self):
        for name, spec in SEARCH_SPACE.items():
            spec.validate(getattr(self, name))

    def token(self) -> tuple:
        """Hashable identity: sorted (name, value) pairs."""
        return tuple(sorted(
            (name, getattr(self, name)) for name in SEARCH_SPACE))

    def to_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in SEARCH_SPACE}

    @classmethod
    def from_dict(cls, d: dict) -> "TunedParams":
        """From a payload: unknown keys (the reference's ``gather_budget``)
        are ignored, missing keys take defaults, out-of-bounds values
        raise."""
        return cls(**{name: int(d[name]) for name in SEARCH_SPACE
                      if name in d})


#: The library defaults, as one canonical object.
DEFAULT_PARAMS = TunedParams()


def sweep_grid(format: str, k: int = 1) -> Iterator[TunedParams]:
    """Candidate :class:`TunedParams` the measured sweep tries for a format,
    sweeping only the knobs the format reads:

    * ``ehyb_packed`` — ``rhs_chunk`` when the plan's rhs width ``k``
      routes to the SpMM kernels (k ≥ 2), else the defaults alone;
    * ``ehyb_bucketed`` — ``n_buckets``;
    * everything else — the defaults only.
    """
    if format == "ehyb_packed" and k >= 2:
        for rc in SEARCH_SPACE["rhs_chunk"].candidates:
            yield TunedParams(rhs_chunk=rc)
    elif format == "ehyb_bucketed":
        for nb in SEARCH_SPACE["n_buckets"].candidates:
            yield TunedParams(n_buckets=nb)
    else:
        yield DEFAULT_PARAMS


def resolve(tuned: Optional[TunedParams]) -> TunedParams:
    """``None`` -> the library defaults (one shared instance)."""
    return DEFAULT_PARAMS if tuned is None else tuned

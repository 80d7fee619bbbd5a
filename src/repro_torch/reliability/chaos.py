"""Deterministic fault injection for the reliability layer.

The port of ``repro.reliability.chaos``.
``chaos(...)`` is a context manager that arms one module-global
:class:`ChaosConfig`; instrumentation points consult it at host dispatch:

* ``check_kernel(name)`` — the guarded apply's chain resolution
  (``reliability.guard``) calls this with a level's site name
  (``"ehyb_packed:native"``, ``"ehyb_packed:unfused"``); a matching
  ``kernel_failure`` fnmatch pattern raises :class:`ChaosFault` there,
  simulating a kernel that fails to build or launch on that level.
* ``corrupt_output(y, level)`` — the guard passes every apply's output
  through this; with ``nan_apply=True`` any non-``"reference"`` level
  returns all-NaN, simulating silent kernel corruption (the solver
  guardrails and the escalation ladder must recover).
* ``check_serve(sparse_active)`` — the serve engine's step wrapper;
  ``serve_apply_failures=N`` raises on the first N calls (transient fault:
  the retry path must absorb it), ``fail_sparse_apply=True`` raises on
  every call made while the sparse head is active (persistent fault: the
  engine must degrade to the dense head).
* ``slow_apply_s`` — sleeps that long at each consulted site (latency
  injection).

Everything is deterministic — no randomness, budgets count down in call
order — so every recovery-path test reproduces exactly.  :func:`flood`
submits a burst of requests to an engine (the overload helper).

Cache hygiene: a decision taken while chaos is armed must not outlive it,
and a healthy cached decision must not mask it.  Entering and exiting bump
a module epoch, and the guard re-resolves its fallback level whenever the
epoch has moved.  There is no compile cache to clear (PyTorch runs
eagerly; the built CUDA libraries hold no decision), so the epoch alone
does what the JAX package's epoch plus ``jax.clear_caches()`` do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import Counter
from fnmatch import fnmatch
from typing import Optional, Tuple

import torch


class ChaosFault(RuntimeError):
    """The injected failure type (distinguishable from organic errors)."""


@dataclasses.dataclass
class ChaosConfig:
    kernel_failure: Tuple[str, ...] = ()   # fnmatch patterns vs site names
    nan_apply: bool = False                # non-reference applies emit NaN
    slow_apply_s: float = 0.0              # sleep per consulted site
    serve_apply_failures: int = 0          # first-N serve step calls fail
    fail_sparse_apply: bool = False        # every sparse-head serve call fails
    injected: Counter = dataclasses.field(default_factory=Counter)

    def _sleep(self) -> None:
        if self.slow_apply_s > 0:
            self.injected["slow"] += 1
            time.sleep(self.slow_apply_s)

    def check_kernel(self, name: str) -> None:
        self._sleep()
        if any(fnmatch(name, pat) for pat in self.kernel_failure):
            self.injected[f"kernel:{name}"] += 1
            raise ChaosFault(f"chaos: injected kernel failure at {name!r}")

    def corrupt_output(self, y: torch.Tensor, level: str) -> torch.Tensor:
        self._sleep()
        if self.nan_apply and level != "reference":
            self.injected["nan"] += 1
            return torch.full_like(y, float("nan"))
        return y

    def check_serve(self, sparse_active: bool = True) -> None:
        self._sleep()
        if self.fail_sparse_apply and sparse_active:
            self.injected["serve:sparse"] += 1
            raise ChaosFault("chaos: injected sparse-head apply failure")
        if self.serve_apply_failures > 0:
            self.serve_apply_failures -= 1
            self.injected["serve:transient"] += 1
            raise ChaosFault("chaos: injected transient serve apply failure")


_ACTIVE: Optional[ChaosConfig] = None
_EPOCH: int = 0


def active() -> Optional[ChaosConfig]:
    """The armed config, or None outside any ``chaos(...)`` context."""
    return _ACTIVE


def epoch() -> int:
    """Monotonic counter bumped on every chaos enter/exit — a decision that
    must not survive an injection boundary records this."""
    return _EPOCH


def check_kernel(name: str) -> None:
    """Module-level convenience: no-op when chaos is unarmed."""
    if _ACTIVE is not None:
        _ACTIVE.check_kernel(name)


@contextlib.contextmanager
def chaos(**kw):
    """Arm a :class:`ChaosConfig` for the dynamic extent of the block.

    Yields the config; its ``injected`` counter records every fault
    actually delivered, so tests assert the injection fired (a recovery
    test that never hits its fault proves nothing).  Contexts do not nest.
    """
    global _ACTIVE, _EPOCH
    if _ACTIVE is not None:
        raise RuntimeError("chaos contexts do not nest")
    cfg = ChaosConfig(**kw)
    _ACTIVE = cfg
    _EPOCH += 1
    try:
        yield cfg
    finally:
        _ACTIVE = None
        _EPOCH += 1


def flood(engine, n: int, *, prompt=None, max_new_tokens: int = 4,
          ttl_s: Optional[float] = None, uid_base: int = 10_000) -> list:
    """Submit ``n`` requests at once (queue-flood helper for overload
    tests).  Returns the Request objects — rejected ones come back with
    ``done=True`` and a ``reject_reason``."""
    import numpy as np

    from ..serve.engine import Request

    p = np.asarray([1, 2, 3] if prompt is None else prompt, np.int32)
    reqs = []
    for i in range(n):
        r = Request(uid=uid_base + i, prompt=p,
                    max_new_tokens=max_new_tokens, ttl_s=ttl_s)
        engine.submit(r)
        reqs.append(r)
    return reqs

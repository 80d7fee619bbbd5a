"""Guarded apply: capability check, probe and ordered fallback chain.

The port of ``repro.reliability.guard``.  A CUDA kernel can fail to build
(``nvcc``), to load or to launch on a card; the apply must not crash for
that, nor hide it.  :func:`guarded_apply` wraps a plan's
``(obj, x) -> y`` apply in a :class:`_Guard` that resolves, once per chaos
epoch, which level of the format's fallback chain runs:

    fused kernel  ->  unfused (ELL-only kernel + plain ER part)  ->  reference

* the **native** level is the format's registered apply (the fused packed
  kernel for ``ehyb_packed``; the plain path for every other format);
* the **unfused** level is the format's ``fallback`` hook when it has one
  (``use_er_kernel=False`` for ``ehyb_packed``; the other six formats go
  native -> reference, as in the JAX package);
* the **reference** level is format-independent: a gather and
  ``index_add_`` over the plan's COO pattern with the values recovered from
  the container (``Plan.values_of``), plain PyTorch on the plan's own
  device, so the chain always ends in a level that needs no kernel.

A kernel level of a CUDA plan is resolved by
``kernels.ops.check_cuda_device`` (in place of the JAX package's
``backend_supports_pallas``) and a probe: the level runs once on a zero
vector on the plan's device, the device is synchronised, and the output
must be finite.  On a CUDA plan only an injected :class:`ChaosFault` moves
a kernel level on to the next one: an organic failure (a failed ``nvcc``
build or load, a refused launch, a CUDA fault, a non-finite probe, a dtype
the kernel does not take) is re-raised, as the kernel wrappers raise, so a
kernel that does not run on the card is never served by a plain level.
A CPU plan's levels run the plain versions and are probed only under
chaos, as the JAX package's pure-XLA chains are; any failure there moves
on.  Every level runs on the plan's device: none moves work to the CPU.  The resolved level is kept
until the chaos epoch moves.  A downgrade is never quiet: it shows in
``plan.degraded``, in the ``guard.downgrade`` and
``guard.downgrade.<format>`` counters (``core.counters``) and in one
:class:`ReliabilityWarning` per (pattern, kind).

A sticky CUDA error (an illegal address) poisons the context, so it is
raised where it happens rather than retried on a later level.
"""

from __future__ import annotations

import warnings

import torch

from ..core.counters import bump
from ..core.spmv import _as_2d, _from_permuted, _to_permuted, coo_product
# the functions, not the module: the package re-exports the chaos() context
# manager under the submodule's name
from .chaos import ChaosFault
from .chaos import active as _chaos_active
from .chaos import check_kernel as _chaos_check_kernel
from .chaos import epoch as _chaos_epoch
from .policy import ReliabilityWarning

_WARNED: set = set()


def reset_warned() -> None:
    _WARNED.clear()


def reference_apply(plan, kind: str = "apply"):
    """The plain CSR reference ``(obj, x) -> y`` for ``plan``, on the plan's
    device: the container's values (``plan.values_of``) times a gather of x
    by the pattern's columns, summed into rows with ``index_add_``.
    ``kind="permuted"`` wraps the same product in the container's
    perm/pad round trip, so it stands in for the permuted hot-loop apply."""

    def ref(obj, x):
        rows, cols = plan.coo_tensors()
        vals = plan.values_of(obj)
        x2, squeeze = _as_2d(x)
        if kind == "permuted":
            xo = _from_permuted(obj, x2, False)
            y, _ = _to_permuted(obj, coo_product(rows, cols, vals, xo,
                                                 plan.n))
        else:
            y = coo_product(rows, cols, vals, x2, plan.n)
        return y[:, 0] if squeeze else y

    return ref


def fallback_chain(plan, kind: str):
    """Ordered ``(name, fn, needs_kernel)`` levels for ``plan``/``kind``;
    ``needs_kernel`` marks a level that launches CUDA kernels."""
    from ..autotune.registry import get_format

    spec = get_format(plan.format)
    native = spec.apply if kind == "apply" else spec.permuted
    kernel = spec.kernel == "cuda" and plan.device.type == "cuda"
    levels = [(f"{plan.format}:native", native, kernel)]
    fb = spec.fallback if kind == "apply" else spec.fallback_permuted
    if fb is not None:
        levels.append((f"{plan.format}:unfused", fb, kernel))
    levels.append(("reference", reference_apply(plan, kind), False))
    return levels


class _Guard:
    """Stable-identity wrapper around a plan's apply.

    Per-call cost on the resolved path: one epoch compare and one chaos
    check before the level's function runs."""

    __slots__ = ("plan", "kind", "level", "chain", "_fn", "_epoch")

    def __init__(self, plan, kind: str):
        self.plan, self.kind = plan, kind
        self.level = None          # resolved level name
        self.chain = ()            # level names, primary first
        self._fn = None
        self._epoch = -1

    def __call__(self, obj, x: torch.Tensor) -> torch.Tensor:
        if self._fn is None or self._epoch != _chaos_epoch():
            self._resolve(obj, x.dtype)
        y = self._fn(obj, x)
        c = _chaos_active()
        if c is not None:
            y = c.corrupt_output(y, self.level)
        return y

    def _probe(self, fn, obj, dtype) -> None:
        """Run ``fn`` once on a zero vector on the plan's device; raise
        unless it runs to the end and gives a finite output."""
        n = obj.n_pad if self.kind == "permuted" else self.plan.n
        y = fn(obj, torch.zeros(n, dtype=dtype, device=self.plan.device))
        if y.device.type == "cuda":
            torch.cuda.synchronize(y.device)
        if not bool(torch.isfinite(y).all()):
            raise FloatingPointError(
                "capability probe produced non-finite output")

    def _resolve(self, obj, dtype) -> None:
        from ..kernels.ops import check_cuda_device

        ep = _chaos_epoch()
        levels = fallback_chain(self.plan, self.kind)
        self.chain = tuple(name for name, _, _ in levels)
        must_probe = _chaos_active() is not None
        failures = []
        chosen = None
        for i, (name, fn, needs_kernel) in enumerate(levels):
            last = i == len(levels) - 1
            try:
                if not last:            # the reference level is exempt
                    _chaos_check_kernel(name)
                if needs_kernel:
                    check_cuda_device(self.plan.device)
                if (needs_kernel or must_probe) and not last:
                    self._probe(fn, obj, dtype)
                chosen = (name, fn)
                break
            except Exception as e:  # noqa: BLE001 — a plain level of a
                # CPU plan may fail in any way under chaos and the next level
                # is tried; a kernel level re-raises all but an injected
                # fault, and the last failure is re-raised below when no
                # level is left
                if needs_kernel and not isinstance(e, ChaosFault):
                    raise
                bump("guard.level_failed")
                failures.append((name, e))
        if chosen is None:
            name, err = failures[-1]
            raise RuntimeError(
                f"guarded apply: every fallback level failed for plan "
                f"{self.plan.key} ({self.kind}); last level {name!r}: {err}"
            ) from err
        self.level, self._fn = chosen
        self._epoch = ep
        if failures:
            bump("guard.downgrade")
            bump(f"guard.downgrade.{self.plan.format}")
            wkey = (self.plan.key, self.kind)
            if wkey not in _WARNED:
                _WARNED.add(wkey)
                tried = "; ".join(f"{n}: {type(e).__name__}: {e}"
                                  for n, e in failures)
                warnings.warn(
                    f"plan {self.plan.key} ({self.plan.format!r}, "
                    f"{self.kind}) degraded to fallback level "
                    f"{self.level!r} after: {tried}",
                    ReliabilityWarning, stacklevel=4)


def guarded_apply(plan, kind: str) -> _Guard:
    """The (cached, stable-identity) guard wrapping ``plan``'s ``kind``
    apply (``"apply"`` or ``"permuted"``) — the hook
    ``api.plan.Plan._raw_apply*`` routes through."""
    g = plan._guards.get(kind)
    if g is None:
        g = plan._guards[kind] = _Guard(plan, kind)
    return g

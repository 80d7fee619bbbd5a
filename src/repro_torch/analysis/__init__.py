"""Static analysis: verify containers, lint the dispatched ops, lint the
source (the port of ``repro.analysis``).

Three passes over three layers of the stack, one
:class:`~repro_torch.analysis.findings.Finding` record type:

* :mod:`repro_torch.analysis.invariants` — the declarative
  format-invariant verifier: ``verify(obj)`` checks any built container or
  operator against its format's structural invariants (via the
  ``FormatSpec.invariants`` registry hook), on the container's device;
  ``verify_plan(plan)`` checks the pattern-only planning layer.
* :mod:`repro_torch.analysis.dispatch_lint` — runs every registered apply
  under a ``TorchDispatchMode`` and checks the aten ops for dtype
  downcasts, bf16 accumulation and host syncs.
* :mod:`repro_torch.analysis.source_lint` — AST lint of the port's source
  (untagged broad excepts, module-scope torch work, deprecated shims,
  wall-clock calls under a compiler).

``python -m repro_torch.analysis`` runs all three and gates against the
port's committed baseline (``src/repro_torch/analysis/baseline.json``).
"""

from .findings import Finding, errors, summarize
from .invariants import format_invariants, verify, verify_plan

__all__ = ["Finding", "errors", "summarize", "verify", "verify_plan",
           "format_invariants"]

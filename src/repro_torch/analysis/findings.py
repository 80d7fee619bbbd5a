"""The structured finding record every analysis pass emits.

The port of ``repro.analysis.findings``.  All three passes — the
format-invariant verifier (``invariants``), the dispatch lint
(``dispatch_lint``) and the repo source lint (``source_lint``) — report
through one record type so callers (``Plan.bind(validate="full")``,
``python -m repro_torch.analysis``) aggregate, filter and baseline them
uniformly.

Severities:

* ``error``   — a violated invariant: the container/program WILL compute
                wrong numbers (or read out of bounds) if executed.
                ``verify``-gated paths raise on these.
* ``warning`` — a hazard that degrades performance or precision without
                corrupting results (bf16 accumulation).  The gate
                ratchets these against the committed baseline: existing
                ones are tolerated, new ones fail.
* ``info``    — observations (rule coverage notes); never gated.
"""

from __future__ import annotations

import dataclasses
from typing import List

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    severity: str     # "error" | "warning" | "info"
    site: str         # where: container/field, traced path, or path:line
    rule: str         # stable kebab-case rule id (what the baseline keys on)
    message: str      # human explanation, with the offending numbers

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def __str__(self):
        return f"[{self.severity}] {self.rule} @ {self.site}: {self.message}"


def errors(findings: List[Finding]) -> List[Finding]:
    """The gating subset: findings a verified path must refuse to run on."""
    return [f for f in findings if f.severity == "error"]


def summarize(findings: List[Finding]) -> dict:
    """Per-rule counts — the shape the committed baseline stores."""
    out: dict = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))

"""``python -m repro_torch.analysis`` — run the three passes, gate on a
baseline.

The committed baseline (``baseline.json`` beside this file; the reference's
``analysis_baseline.json`` at the repo root is the JAX package's) stores
per-pass, per-rule finding *counts*.  The gate is a ratchet: a run fails
when any rule's count exceeds its baselined count — existing debt is
tolerated but frozen; new findings of any rule fail.  Shrinking debt is
recorded by re-writing the baseline (``--write-baseline``).

    python -m repro_torch.analysis                      # all three passes
    python -m repro_torch.analysis --source             # one pass
    python -m repro_torch.analysis --baseline other.json
    python -m repro_torch.analysis --write-baseline \\
        src/repro_torch/analysis/baseline.json

Every pass runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

from .findings import Finding, summarize

PASSES = ("source", "dispatch", "invariants")
BASELINE = Path(__file__).resolve().parent / "baseline.json"


def run_invariants_pass() -> List[Finding]:
    """Build every registered format on the probe matrix (on the CPU) and
    verify each — the clean-suite leg of the corruption regression."""
    from ..autotune.registry import available_formats, build_format
    from .dispatch_lint import _probe_matrix
    from .invariants import verify

    m = _probe_matrix()
    out: List[Finding] = []
    for fmt in available_formats():
        out += verify(build_format(fmt, m, None, {}, device="cpu"))
    return out


def run_pass(name: str) -> List[Finding]:
    if name == "source":
        from .source_lint import run_source_lint

        return run_source_lint()
    if name == "dispatch":
        from .dispatch_lint import run_dispatch_lint

        return run_dispatch_lint()
    return run_invariants_pass()


def gate(results: Dict[str, List[Finding]],
         baseline: Dict[str, Dict[str, int]]) -> List[str]:
    """Ratchet: violations where a rule's count exceeds its baseline."""
    violations = []
    for pname, findings in results.items():
        base = baseline.get(pname, {})
        gated = [f for f in findings if f.severity != "info"]
        for rule, count in summarize(gated).items():
            if count > base.get(rule, 0):
                violations.append(
                    f"{pname}: rule {rule!r} has {count} finding(s), "
                    f"baseline allows {base.get(rule, 0)}")
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis: source lint, dispatch lint, "
                    "format-invariant verifier")
    for p in PASSES:
        ap.add_argument(f"--{p}", action="store_true",
                        help=f"run only the {p} pass (default: all)")
    ap.add_argument("--baseline", type=Path, default=BASELINE,
                    help="gate against this per-rule count baseline "
                         "(default: the port's committed one)")
    ap.add_argument("--write-baseline", type=Path, default=None,
                    help="write the observed counts as the new baseline")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only the summary and violations")
    args = ap.parse_args(argv)

    selected = [p for p in PASSES if getattr(args, p)] or list(PASSES)
    results: Dict[str, List[Finding]] = {}
    for pname in selected:
        results[pname] = run_pass(pname)
        if not args.quiet:
            for f in results[pname]:
                print(f"{pname}: {f}")
        print(f"{pname}: {len(results[pname])} finding(s) "
              f"{summarize(results[pname])}")

    if args.write_baseline is not None:
        payload = {p: summarize([f for f in fs if f.severity != "info"])
                   for p, fs in results.items()}
        args.write_baseline.write_text(json.dumps(payload, indent=2,
                                                  sort_keys=True) + "\n")
        print(f"baseline written: {args.write_baseline}")
        return 0

    violations = gate(results, json.loads(args.baseline.read_text()))
    for v in violations:
        print(f"VIOLATION {v}")
    if violations:
        return 1
    print("static analysis: clean against baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main())

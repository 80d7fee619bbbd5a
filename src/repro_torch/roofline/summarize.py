"""The dry run's records as the roofline tables, one a mesh.

The port of ``repro.roofline.summarize``: the same table and notes, over
``launch.dryrun``'s records (``build/dryrun/<mesh>/<arch>__<shape>.json``).
A cell recorded without a cost (a serving cell, or one recorded with
``--args-only``) prints its reason in place of the terms.

  PYTHONPATH=src python -m repro_torch.roofline.summarize [DIR]
"""

from __future__ import annotations

import glob
import json
import os
import sys

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = ("single_pod_16x16", "multi_pod_2x16x16")


def load_records(base: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(base, "*", "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_s(x):
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def table(recs, mesh: str) -> str:
    rows = [r for r in recs if r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])))
    lines = [
        "| arch | shape | status | compute | memory | collective | dominant "
        "| mem/dev GiB | 6·N·D / HLO | bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] != "OK":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['status']} | — | — | — "
                f"| — | — | — | {r.get('reason','')[:60]} |")
            continue
        if "roofline" not in r:
            mem = r["memory"]["argument_bytes"] / 2**30
            lines.append(
                f"| {r['arch']} | {r['shape']} | OK | — | — | — | — "
                f"| {mem:.1f} (args) | — | {r.get('cost_reason', '')} |")
            continue
        t = r["roofline"]
        mem = r["memory"]["peak_estimate_bytes"] / 2**30
        note = bottleneck_note(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | OK | {fmt_s(t['compute_s'])} "
            f"| {fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} "
            f"| **{t['dominant']}** | {mem:.1f} | {t['useful_ratio']:.2f} "
            f"| {note} |")
    return "\n".join(lines)


def bottleneck_note(r) -> str:
    t = r["roofline"]
    top = r.get("collectives_top", [])
    if t["dominant"] == "collective" and top:
        biggest = top[0]["op"].split(" ")[0]
        return (f"top collective: {biggest} "
                f"{top[0]['bytes']/1e9:.0f} GB/step — reduce via sharding "
                f"change")
    if t["dominant"] == "compute":
        if t["useful_ratio"] < 0.6:
            return "compute-bound but low useful ratio — cut remat/mask waste"
        return "compute-bound near model FLOPs — healthy"
    return "memory-bound — increase arithmetic intensity (fusion/batching)"


def main(argv=None) -> int:
    from ..launch.dryrun import OUT_DIR

    argv = sys.argv[1:] if argv is None else argv
    recs = load_records(argv[0] if argv else OUT_DIR)
    for mesh in MESHES:
        n_ok = sum(1 for r in recs if r["mesh"] == mesh
                   and r["status"] == "OK")
        print(f"\n## {mesh} ({n_ok} OK)\n")
        print(table(recs, mesh))
    return 0


__all__ = ["load_records", "table", "bottleneck_note", "fmt_s", "main"]


if __name__ == "__main__":
    raise SystemExit(main())

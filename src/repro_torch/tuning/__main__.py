"""CLI for the tuning subsystem.

``python -m repro_torch.tuning --report``     print the active calibration
``python -m repro_torch.tuning --calibrate``  measure → fit → persist →
                                              report
``python -m repro_torch.tuning --stats``      active store contents and
                                              counters

``--device`` (default ``cuda``) is where ``--calibrate`` measures and whose
backend ``--report`` reads; ``--device cpu`` calibrates the plain formats
on the host.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning",
        description="calibrated-autotuning utilities")
    ap.add_argument("--report", action="store_true",
                    help="print the active calibration model")
    ap.add_argument("--calibrate", action="store_true",
                    help="run the measure/fit loop, persist into the active "
                         "store, and print the resulting report")
    ap.add_argument("--stats", action="store_true",
                    help="print the active tune store's entries + counters")
    ap.add_argument("--suite", nargs="*", default=None, metavar="NAME",
                    help="suite matrices to calibrate on (default: the "
                         "standard calibration subset)")
    ap.add_argument("--device", default=None,
                    help="device to calibrate on / report for "
                         "(default: cuda)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of tables")
    args = ap.parse_args(argv)
    if not (args.report or args.calibrate or args.stats):
        ap.print_help()
        return 2

    from . import calibration, store

    if args.calibrate:
        out = calibration.calibrate(names=args.suite or None,
                                    device=args.device)
        if args.json:
            print(json.dumps({"model": out["model"],
                              "evaluation": out["evaluation"],
                              "persisted": out["persisted"]}, indent=2))
        else:
            print(calibration.report(device=args.device))
            ev = out["evaluation"]
            print(f"agreement (of {ev['contested']} contested): "
                  f"calibrated={ev['agree_calibrated']} "
                  f"raw-bytes={ev['agree_raw']}  "
                  f"ratio geomean={ev['ratio_geomean']:.3f} "
                  f"[{ev['ratio_min']:.3f}, {ev['ratio_max']:.3f}]")
            print("persisted" if out["persisted"]
                  else "not persisted (no active store)")
    elif args.report:
        if args.json:
            model = calibration.get_model(
                calibration._backend(args.device))
            print(json.dumps(None if model is None else model.to_dict(),
                             indent=2))
        else:
            print(calibration.report(device=args.device))
    if args.stats:
        st = store.get_store()
        payload = None if st is None else st.stats()
        print(json.dumps(payload, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

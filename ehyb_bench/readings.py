"""The readings that a cell's limits are set from, in one process:

    python3 ehyb_bench/readings.py --workload <cell> --seeds 1 2 ... \\
        [--seconds 2] [--control-seeds 7 8 9]

For each of ``--seeds`` the program's window (``--seconds`` long) is run
on that seed's inputs and judged as a run judges it; for each of
``--control-seeds`` the control (``reference/control.py``: the reference
in bfloat16, in the program's place) answers every input of the pool once
and is judged the same way.  The matrix, plan and bind are made once.
Prints one JSON line a reading; needs a CUDA device."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from ehyb_bench import harness as H  # noqa: E402
from ehyb_bench.reference.control import ControlOperator  # noqa: E402
from ehyb_bench.reference.rows import PaddedRows  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = H.resolve(H.load_manifest(), args.workload)
    dev = torch.device("cuda:0")
    sync = torch.cuda.synchronize
    dtype = getattr(torch, cell.config["dtype"])
    matrix = H.make_matrix(cell, dev)
    loop = H._module("loops", cell.traffic["loop"])
    ref = PaddedRows(matrix, dev)
    if args.seeds:
        op, spans = H.build_program(cell, matrix, dev, sync)
        for seed in args.seeds:
            inputs = loop.make_inputs(cell.traffic, matrix.n, dtype, seed,
                                      dev)
            loop.warm(op, inputs, cell.traffic, sync)
            win = loop.window(op, inputs, cell.traffic, args.seconds, sync)
            checks = H.judge(cell, loop, ref, inputs, win.pop("answers"))
            print(json.dumps({"side": "program", "seed": seed,
                              "attempted": win["attempted"],
                              "failed": win["failed"], "checks": checks,
                              "iters": win.get("iters", [])[:16]}),
                  flush=True)
        del op
        H.free_program()
    if args.control_seeds:
        ctrl = ControlOperator(matrix, dev)
        for seed in args.control_seeds:
            inputs = loop.make_inputs(cell.traffic, matrix.n, dtype, seed,
                                      dev)
            t0 = time.perf_counter()
            answers = loop.control_answers(ctrl, inputs, cell.traffic)
            checks = H.judge(cell, loop, ref, inputs, answers)
            print(json.dumps({"side": "control", "seed": seed,
                              "checks": checks,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

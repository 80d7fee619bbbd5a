"""Run one cell of the benchmark of ``repro_torch`` once:

    python3 ehyb_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout; ``--list`` prints every cell and the files it
resolves to.  The last line of standard output is the result's JSON
object; the numbers the check compared, each beside its limit, are the last
lines of standard error."""

import time

T_START = time.perf_counter()   # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches of the program stay at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from ehyb_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))

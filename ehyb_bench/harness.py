"""The benchmark of ``repro_torch``, driven by files.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix.  Everything that belongs to one of them is a file of its own, found by
name, so a later cell, configuration, mix or metric is added as new files:

* ``configs/<config>.json``   the matrix: generator, parameters, dtype and
                              the pinned plan settings;
* ``matrices/<generator>.py`` ``generate(params, device) -> Matrix``;
* ``traffic/<mix>.json``      the mix's parameters, ``loop`` naming its kind;
* ``loops/<kind>.py``         inputs from the seed, warm-up, window, the
                              profiled work and the check of the answers;
* ``limits/<cell>.json``      the limit of every number the check compares;
* ``metrics/<metric>.py``     ``read(ctx)``: one per-layer metric, or None
                              where the run has nothing to read.

A run makes its matrix and inputs, plans and binds the operator (set-up),
runs the loop's window, reads the device's peak memory, in a traced run
times the layers and profiles a short window, frees the program's state,
and judges the window's answers against the plain reference
(``reference/``), which imports nothing of the program.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    files: dict


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _in_cell(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its files read; raises if one is
    missing."""
    bench = root / BENCH.name
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    files = {"config": root / conf["file"],
             "traffic": bench / "traffic" / f"{entry['traffic']}.json",
             "limits": bench / "limits" / f"{workload}.json"}
    missing = [str(p) for p in files.values() if not p.is_file()]
    if missing:
        raise FileNotFoundError(f"{workload}: missing {missing}")
    config = json.loads(files["config"].read_text())
    traffic = json.loads(files["traffic"].read_text())
    files["generator"] = bench / "matrices" / f"{config['generator']}.py"
    files["loop"] = bench / "loops" / f"{traffic['loop']}.py"
    per_layer = [m for m in manifest["per_layer"] if _in_cell(m, workload)]
    for m in per_layer:
        files[f"metric:{m['name']}"] = bench / "metrics" / f"{m['name']}.py"
    missing = [str(p) for p in files.values() if not p.is_file()]
    if missing:
        raise FileNotFoundError(f"{workload}: missing {missing}")
    return Cell(name=workload, chips=entry["chips"], config=config,
                traffic=traffic,
                limits=json.loads(files["limits"].read_text()),
                end_to_end=[m for m in manifest["end_to_end"]
                            if _in_cell(m, workload)],
                per_layer=per_layer, files=files)


def list_cells(root: Path = ROOT) -> list:
    """Every cell of the manifest with the files it resolves to."""
    manifest = load_manifest(root)
    out = []
    for w in manifest["workloads"]:
        cell = resolve(manifest, w["name"], root)
        out.append({"name": cell.name,
                    "files": {k: str(p.relative_to(root))
                              for k, p in cell.files.items()}})
    return out


def _module(kind: str, name: str):
    return importlib.import_module(f"{BENCH.name}.{kind}.{name}")


def _reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "ehyb_bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_matrix(cell: Cell, device):
    """The configuration's matrix on the host, checked against the sizes
    its file states; nothing of its generation stays on the device."""
    import torch

    m = _module("matrices", cell.config["generator"]).generate(
        cell.config["params"], device)
    for key, got in (("n", m.n), ("nnz", m.nnz)):
        want = cell.config.get(key)
        if want is not None and want != got:
            raise ValueError(f"{cell.config['name']}: {key} {got}, "
                             f"its file states {want}")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return m


def build_program(cell: Cell, matrix, device, sync):
    """``plan`` and the first ``bind`` of the configuration's matrix, with
    the plan pinned as its file says; returns the operator and the host
    seconds of each, each ending in a synchronise."""
    import torch
    from repro_torch.api import ExecutionConfig, plan
    from repro_torch.core.matrices import SparseCSR

    csr = SparseCSR(matrix.n, matrix.indptr, matrix.indices, matrix.data)
    execution = ExecutionConfig(k=cell.traffic["rhs"],
                                dtype=getattr(torch, cell.config["dtype"]),
                                **cell.config["plan"])
    t0 = time.perf_counter()
    p = plan(csr, execution=execution, device=device)
    sync()
    t1 = time.perf_counter()
    op = p.bind(csr)
    sync()
    return op, {"plan_s": t1 - t0, "bind_s": time.perf_counter() - t1}


def free_program() -> None:
    """Drop every plan the program memoized and return its memory."""
    import torch
    from repro_torch.api import PLAN_CACHE

    PLAN_CACHE.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(cell: Cell, loop, ref, inputs: dict, answers: list) -> dict:
    """Every number the loop compares against the reference ``ref``
    (``reference.rows.PaddedRows``), beside its limit."""
    numbers = loop.check(ref, inputs, answers)
    if set(numbers) != set(cell.limits):
        raise KeyError(f"{cell.name}: the check gives {sorted(numbers)}, "
                       f"the limits file {sorted(cell.limits)}")
    return {k: {"value": v, "limit": cell.limits[k]}
            for k, v in numbers.items()}


def _floors(cell: Cell, matrix) -> dict:
    import torch

    from ehyb_bench import floors

    size = torch.empty((), dtype=getattr(torch, cell.config["dtype"])) \
        .element_size()
    return {"floor_apply_s": floors.apply_floor_s(
                matrix.n, matrix.nnz, cell.traffic["rhs"], size),
            "floor_iter_s": floors.cg_iter_floor_s(matrix.n, matrix.nnz,
                                                   size)}


def measure_layers(op, inputs: dict, cell: Cell, loop, sync) -> dict:
    """The traced run's readings after the window: CUDA-event times of the
    permuted-space and the original-space apply, and a profiled window of
    the loop's own work."""
    from repro_torch.api import Space

    from ehyb_bench import trace

    x = inputs["pool"][0]
    x_new = op.to_space(x)
    events = {"permuted": trace.event_ms(
                  lambda: op.apply(x_new, space=Space.PERMUTED)),
              "original": trace.event_ms(lambda: op @ x)}
    prof = trace.profile(
        lambda: loop.profiled_work(op, inputs, cell.traffic, sync))
    return {"event_ms": events, "profile": prof}


def _program_state(op) -> dict:
    """What the program counted and timed in its set-up: ``core.counters``
    (nvcc runs, library loads, guard levels, solver status) and the host
    build's stage seconds."""
    from repro_torch.core import counters

    host = op.plan._shared.get("ehyb")
    return {"counters": counters.snapshot(),
            "preprocess_seconds": getattr(host, "preprocess_seconds", None)}


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def execute(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> tuple:
    """One run of ``cell``: the result line's object, and beside it what
    the run's earlier line reports (the loop's window, the program's
    counters and stage seconds, the set-up spans)."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    matrix = make_matrix(cell, dev)
    matrix_s = time.perf_counter() - t0
    loop = _module("loops", cell.traffic["loop"])
    inputs = loop.make_inputs(cell.traffic, matrix.n,
                              getattr(torch, cell.config["dtype"]), seed, dev)
    if cuda:
        from repro_torch.kernels.build import build_all

        build_all()
        sync()
        torch.cuda.reset_peak_memory_stats()
    op, spans = build_program(cell, matrix, dev, sync)
    t0 = time.perf_counter()
    loop.warm(op, inputs, cell.traffic, sync)
    sync()
    spans.update(matrix_s=matrix_s, warm_s=time.perf_counter() - t0)
    setup_s = time.perf_counter() - t_start
    win = loop.window(op, inputs, cell.traffic, seconds, sync)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    layers = measure_layers(op, inputs, cell, loop, sync) if trace else {}
    state = _program_state(op)
    answers = win.pop("answers")
    del op
    free_program()
    from ehyb_bench.reference.rows import PaddedRows

    checks = judge(cell, loop, PaddedRows(matrix, dev), inputs, answers)
    del answers
    e2e = dict(win["e2e"], setup_s=setup_s)
    if peak is not None:
        e2e["peak_mem_gib"] = peak / 2 ** 30
    metrics = {}
    if trace:
        ctx = dict(_floors(cell, matrix), window=win, spans=spans, **layers)
        for m in cell.per_layer:
            value = _reader(cell.files[f"metric:{m['name']}"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics}
    if cuda:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(dev),
                            "count": 1, "memory_peak_bytes": peak}
    prof = layers.get("profile", {})
    if "busy_s" in prof:
        result["device"].update(busy_s=prof["busy_s"],
                                window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    return result, {"window": win, "state": state, "spans": spans}


def forbidden(names) -> list:
    """The module names among ``names`` whose top-level name is one of
    :data:`FORBIDDEN`, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true",
                    help="print every cell and the files it resolves to")
    args = ap.parse_args(argv)
    if args.list:
        print(json.dumps(list_cells(), indent=1))
        return 0
    if not args.workload:
        ap.error("--workload is required")
    cell = resolve(load_manifest(), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, extra = execute(cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device="cuda:0",
                            t_start=t_start)
    win = extra["window"]
    bad = forbidden(list(sys.modules))
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    info = {"cell": cell.name, "seed": args.seed, "card": _power_limit(),
            "spans": extra["spans"], **extra["state"]}
    if "iters" in win:
        info["iters"] = {"min": min(win["iters"]), "max": max(win["iters"])}
    if len(win.get("latencies_s", ())) > 1:
        lat = sorted(win["latencies_s"])
        info["latency_ms"] = {
            "min": lat[0] * 1e3,
            "quartiles": [q * 1e3 for q in statistics.quantiles(lat, n=4)],
            "max": lat[-1] * 1e3,
            "first": [t * 1e3 for t in win["latencies_s"][:4]]}
    print("[bench] " + json.dumps(info), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}={c['value']!r} limit={c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

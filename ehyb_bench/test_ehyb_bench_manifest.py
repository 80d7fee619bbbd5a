"""BENCHMARK.json against the benchmark's contract, the harness finding a
cell added as files alone, and no module of JAX or of the JAX package in a
run."""

import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from ehyb_bench import harness

MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _cells_of(metric):
    return metric.get("workloads", CELLS)


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 0 < len(w["why"]) <= 200
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    names += CELLS
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_end_to_end_bounds_and_sources():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup


def test_every_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(_cells_of(m)) <= set(_cells_of(e2e[m["moves"]]))
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layer = m["layer"]
        assert 0 < len(layer) <= 200 and "\n" not in layer
    for cell in CELLS:
        reports = [n for n, m in e2e.items() if cell in _cells_of(m)]
        assert "setup_s" in reports and len(reports) >= 2
        assert any(cell in _cells_of(m) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_to_its_files(workload):
    cell = harness.resolve(MANIFEST, workload)
    assert all(p.is_file() for p in cell.files.values())
    assert cell.files["loop"].parent.name == "loops"
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_a_cell_added_as_files_is_found(tmp_path):
    """A config and a mix added in a scratch copy, with a limits file and
    the manifest's new entries, are listed by run.py; no file that was
    there is edited."""
    shutil.copytree(harness.BENCH, tmp_path / "ehyb_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "ehyb_bench").rglob("*")
              if p.is_file()}
    bench = tmp_path / "ehyb_bench"
    (bench / "configs" / "tiny_grid.json").write_text(json.dumps(
        {"name": "tiny_grid", "generator": "hpcg27", "dtype": "float32",
         "params": {"nx": 4, "ny": 4, "nz": 4}, "reduced": [],
         "plan": {"format": "ehyb_packed", "partition_method": "bfs"}}))
    (bench / "traffic" / "cg_loose.json").write_text(json.dumps(
        {"loop": "cg", "rhs": 1, "pool": 2, "method": "cg",
         "precond": "jacobi", "tol": 1e-4, "max_iters": 100}))
    (bench / "limits" / "tiny_grid.cg_loose.json").write_text(
        json.dumps({"rel_residual": 1e-3}))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append(
        {"name": "tiny_grid", "source": "https://example.org/tiny",
         "file": "ehyb_bench/configs/tiny_grid.json", "reduced": [],
         "why": "a test"})
    manifest["workloads"].append(
        {"name": "tiny_grid.cg_loose", "config": "tiny_grid",
         "traffic": "cg_loose", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = subprocess.run([sys.executable, "ehyb_bench/run.py", "--list"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    listed = {c["name"]: c["files"] for c in json.loads(out.stdout)}
    assert set(listed) == set(CELLS) | {"tiny_grid.cg_loose"}
    files = listed["tiny_grid.cg_loose"]
    assert files["config"] == "ehyb_bench/configs/tiny_grid.json"
    assert files["generator"] == "ehyb_bench/matrices/hpcg27.py"
    assert files["loop"] == "ehyb_bench/loops/cg.py"
    assert all(p.read_bytes() == b for p, b in before.items())


def test_no_card_means_no_result(tmp_path):
    """Without a CUDA device the run exits non-zero and prints no result,
    also from a directory that holds only the benchmark's files."""
    shutil.copytree(harness.BENCH, tmp_path / "ehyb_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (harness.ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "ehyb_bench/run.py", "--workload", CELLS[0],
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
            capture_output=True, text=True, timeout=120,
            env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
        assert out.returncode != 0
        assert '"correct"' not in out.stdout


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden(["repro_torch.api", "jaxtyping", "reproduce",
                              "numpy"]) == []
    assert harness.forbidden(["repro.core", "jax", "jaxlib.xla_client",
                              "flax.linen", "repro_torch"]) == \
        ["flax.linen", "jax", "jaxlib.xla_client", "repro.core"]


_IMPORTS = textwrap.dedent("""
    import json, sys, time
    sys.path[:0] = [{root!r}, {src!r}]
    from ehyb_bench import harness, tiny
    from ehyb_bench.reference import control, rows
    pure = sorted({{m.split(".")[0] for m in sys.modules}})
    for w in {cells!r}:
        cell = tiny.tiny_cell(w)
        harness.execute(cell, seed=3, seconds=0.05, trace=False,
                        device="cpu", t_start=time.perf_counter())
        for key, path in cell.files.items():
            if key.startswith("metric:"):
                harness._reader(path)
    print(json.dumps({{"pure": pure,
                      "all": sorted({{m.split(".")[0]
                                     for m in sys.modules}})}}))
""")


def test_no_jax_or_repro_module_is_loaded():
    """Every module a run loads (harness, generators, loops, readers,
    reference, the program) has a top-level name other than jax, jaxlib,
    flax and repro; the reference loads nothing of the program."""
    code = _IMPORTS.format(root=str(harness.ROOT),
                           src=str(harness.ROOT / "src"), cells=CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" not in tops["pure"]
    assert "repro_torch" in tops["all"]
    assert harness.forbidden(tops["all"]) == []

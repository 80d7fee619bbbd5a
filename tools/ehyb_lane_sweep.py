#!/usr/bin/env python3
"""Lane-group widths and the row-width table of the EHYB SpMV kernels, on
one NVIDIA Hopper card.

    python3 tools/ehyb_lane_sweep.py [--nx 64]

The kernels in ``src/repro_torch/csrc/ehyb_spmv.cu`` fix their lane-group
widths at compile time: ``kErLanes`` lanes an ER row (#1 ``ehyb_fused`` and
#2 ``ehyb_packed_fused``) and ``row_lanes`` lanes a row of the uniform
tiles (#1, and #4 ``ehyb_ell``).  This probe builds a copy of that source
for each width G in (4, 8, 16, 32), with every group G lanes wide, and
times #1, #2 and #4 through the port's own wrappers on
``elasticity3d(nx)`` (the solver's k = 1 plan, fp32), each against its
plain version.  With the library as it is in the source, it also times #1
and #4 with a ``col_rows`` that makes every row W wide, so they read the
tiles' padded tail: what the width table saves.

Times as in ``chip_smoke.py``: CUDA events, the median of 20 launches, L2
flushed before each.  One line per measurement; the card's name and power
limit first.  Needs a card and ``nvcc``; exits non-zero without them.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
WIDTHS = (4, 8, 16, 32)
# the source's lane constants, and what each becomes in the G-wide copy
SUBST = (("constexpr int kErLanes = 4;", "constexpr int kErLanes = {g};"),
         ("return ell_only ? 8 : 4;", "return {g};"))


def variant_sources(out: Path) -> dict:
    """{G: path of a copy of csrc/ehyb_spmv.cu with every group G wide}."""
    from repro_torch.kernels import build

    src = (build.CSRC / "ehyb_spmv.cu").read_text()
    for old, _ in SUBST:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/ehyb_spmv.cu no longer holds {old!r}")
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for g in WIDTHS:
        text = src
        for old, new in SUBST:
            text = text.replace(old, new.format(g=g))
        paths[g] = out / f"ehyb_spmv_g{g}.cu"
        paths[g].write_text(text)
    return paths


def build_variants(sources: dict) -> dict:
    """{G: loaded library}, one nvcc per copy, all started together."""
    from repro_torch.kernels import build

    nvcc = build.find_nvcc()
    procs = {g: (subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", str(p.with_suffix(".so")), str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), p)
        for g, p in sources.items()}
    libs = {}
    for g, (proc, p) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the G = {g} copy:\n{out}")
        libs[g] = ctypes.CDLL(str(p.with_suffix(".so")))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ehyb_lane_sweep: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=64)
    args = ap.parse_args()

    from chip_smoke import log, rel_err, time_ms
    from repro_torch.api import ExecutionConfig, plan
    from repro_torch.core.matrices import elasticity3d
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ehyb_spmv as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    libs = build_variants(variant_sources(build.BUILD_DIR / "lane_sweep"))
    default = build.load("ehyb_spmv")
    m = elasticity3d(args.nx)
    cfg = dict(partition_method="bfs")
    op = plan(m, execution=ExecutionConfig(format="ehyb_packed", **cfg),
              device=dev).bind(m)
    u = plan(m, execution=ExecutionConfig(format="ehyb", **cfg),
             device=dev).bind(m).obj
    o = op.obj
    x_new = op.to_space(torch.randn(
        m.n, generator=torch.Generator().manual_seed(0)).to(dev))
    xp = x_new.reshape(o.n_parts, o.vec_size)
    stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
    plain = {
        "ehyb_fused": ref.ehyb_fused_stream_ref(
            x_new[:, None], u.ell_vals, u.ell_cols, u.er_stream())[:, 0],
        "ehyb_packed_fused": ref.ehyb_packed_fused_stream_ref(
            x_new[:, None], *stair, o.er_stream(), o.vec_size)[:, 0],
        "ehyb_ell": ref.ehyb_ell_ref(xp[..., None], u.ell_vals,
                                     u.ell_cols)[..., 0]}

    def calls(col_rows_u):
        return {
            "ehyb_fused": lambda: K.ehyb_fused(
                x_new, u.ell_vals, u.ell_cols, col_rows_u, u.er_stream()),
            "ehyb_packed_fused": lambda: K.ehyb_packed_fused(
                x_new, *stair, o.er_stream(), vec_size=o.vec_size),
            "ehyb_ell": lambda: K.ehyb_ell(xp, u.ell_vals, u.ell_cols,
                                           col_rows_u)}

    def measure(label: str, col_rows_u, names) -> None:
        cs = calls(col_rows_u)
        for k in names:
            err = rel_err(cs[k]().double().cpu(), plain[k].double().cpu())
            if err > 1e-4:
                raise AssertionError(f"{label} {k}: {err} from the plain "
                                     f"version")
            log("lane-sweep", variant=label, kernel=k,
                ms=time_ms(cs[k], dev), vs_plain=err)

    def use(lib) -> None:
        build._LIBS["ehyb_spmv"] = lib
        build.entry.cache_clear()       # the wrappers' typed entry points

    try:
        for g, lib in libs.items():
            use(lib)
            measure(f"G={g}", u.col_rows, plain)
        use(default)
        measure("source", u.col_rows, plain)
        measure("source, every row W wide",
                torch.full_like(u.col_rows, u.vec_size),
                ("ehyb_fused", "ehyb_ell"))
    finally:
        use(default)
    return 0


if __name__ == "__main__":
    sys.exit(main())

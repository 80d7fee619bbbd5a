#!/usr/bin/env python3
"""Lane-group widths, the row-width table and the SpMM x-tile layout of the
EHYB kernels, and the launch shape of the CG step, on one NVIDIA Hopper
card.

    python3 tools/ehyb_lane_sweep.py [--nx 64] [--sweep spmv,spmm,cg]

The kernels fix these choices at compile time.  This probe builds a copy of
a source for each value, one ``nvcc`` each, all started together, and times
the kernels through the port's own wrappers on ``elasticity3d(nx)`` (fp32),
each against its plain version:

* ``spmv`` — ``src/repro_torch/csrc/ehyb_spmv.cu`` with every lane group G
  wide, G in (4, 8, 16, 32): ``kErLanes`` (an ER row of #1 ``ehyb_fused``
  and #2 ``ehyb_packed_fused``), ``row_lanes`` (a row of the uniform tiles
  of #1 and #4 ``ehyb_ell``) and ``kErRowLanes`` (a row of the ER table of
  #6 ``er``), and at G = 4 and 8 also with ``kErRowUnroll`` (#6's entries
  in flight a lane) at 8 in place of 4; #1, #2, #4 and #6 (at R = 1 and
  16) on the solver's k = 1 plan.  With the library as it is in the
  source, it also times #1 and #4 with a ``col_rows`` that makes every row
  W wide, so they read the tiles' padded tail: what the width table saves.
* ``spmm`` — ``src/repro_torch/csrc/ehyb_spmm.cu`` at each ER group width
  ``kErGroupLanes`` in (4, 8, 16, 32) (a live ER row's lanes: the chunk's
  columns times the sub-groups its entries are split over) and each x-tile
  layout ``kXRowMajor`` (false: [j][v], scalar loads; true: [v][j] with
  16-byte loads and a swizzle), and at 16 lanes also with ``kEllUnroll``
  (packed ELL entries in flight a thread) at 8 in place of 4; #7–#10 at
  K = 16 on the k = 16 plan (fp32 and bf16) and on the k = 1 plan (Kc =
  4).  Then, with the rest as in the source, the uniform kernels' lane
  group ``kUniformLanes`` in (1, 2, 4, 8, 16) (a row of the tile; 1 is a
  thread a row, read to its width), thread cap
  ``kUniformThreads`` in (512, 1024) and ``kUniformUnroll`` (entries in
  flight a lane) in (4, 8): #7 and #9 on both plans.  Last, #7–#10 with
  the kernel's launch bounds stating the thread cap alone, without the
  blocks an SM (``min_blocks``, 1 but for a 512-thread uniform ELL-only
  block): what that argument does to ptxas's register budget.
* ``cg`` — ``src/repro_torch/csrc/solver_step.cu`` at each ``kThreads``
  (threads a block) in (128, 256, 512), ``kUnits`` (8-element units a
  thread per chunk) in (1, 2, 4) and ``kBlocksPerSm`` (the grid's cap) in
  (2, 4, 8), and at the source's 256 · 2 · 4 two alternatives to its design
  (``CG_ALTERNATIVES``); #3 ``fused_cg_update`` at ``--cg-n`` elements (default
  789,888: elasticity3d(64)'s n_pad on an H100, 132 × 5,984) in fp32 and
  bf16, on random vectors and a positive minv; then, at the source's
  constants, at 1, 2, 4 and 8 times n, with L2 left dirty by the flush (as
  every other time here) and clean, beside ``torch.add`` under the same
  timer: the fixed cost of one launch and the streaming rate.

Times as in ``chip_smoke.py``: CUDA events, the median of 20 launches, L2
flushed before each.  One line per measurement; the card's name and power
limit first.  Needs a card and ``nvcc``; exits non-zero without them.
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
WIDTHS = (4, 8, 16, 32)
# {source: {variant: ((the source's constant, what it becomes), ...)}}
SPMV_SUBST = (("constexpr int kErLanes = 4;", "constexpr int kErLanes = {g};"),
              ("return ell_only ? 8 : 4;", "return {g};"),
              ("constexpr int kErRowLanes = 4;",
               "constexpr int kErRowLanes = {g};"),
              ("constexpr int kErRowUnroll = 4;",
               "constexpr int kErRowUnroll = {u};"))
LAUNCH_BOUNDS = ("__launch_bounds__(max_threads(KC, PACKED),\n"
                 "                                  min_blocks(KC, PACKED, HAS_ER))")
SPMM_SUBST = (("constexpr int kEllUnroll = 4;",
               "constexpr int kEllUnroll = {u};"),
              ("constexpr int kErGroupLanes = 4;",
               "constexpr int kErGroupLanes = {g};"),
              ("constexpr bool kXRowMajor = true;",
               "constexpr bool kXRowMajor = {row_major};"),
              ("constexpr int kUniformLanes = 4;",
               "constexpr int kUniformLanes = {lanes};"),
              ("constexpr int kUniformUnroll = 4;",
               "constexpr int kUniformUnroll = {uunroll};"),
              ("constexpr int kUniformThreads = 1024;",
               "constexpr int kUniformThreads = {threads};"),
              (LAUNCH_BOUNDS, "{launch_bounds}"))
# the uniform kernels' constants and the launch bounds as the source has
# them
SPMM_SOURCE = {"lanes": 4, "uunroll": 4, "threads": 1024,
               "launch_bounds": LAUNCH_BOUNDS}
UNIFORM = ("ehyb_fused_spmm", "ehyb_ell_spmm")

CG_E0 = "e0[j] = c * kChunk + ((long long)j * kThreads + threadIdx.x) * V;"
CG_TICKET = """    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t(*ticket);
    s_last = t.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
"""
CG_SUBST = (("constexpr int kThreads = 256;", "constexpr int kThreads = {t};"),
            ("constexpr int kUnits = 2;", "constexpr int kUnits = {u};"),
            ("constexpr int kBlocksPerSm = 4;",
             "constexpr int kBlocksPerSm = {b};"),
            (CG_E0, "{e0}"), (CG_TICKET, "{ticket}"))
# the two alternatives timed beside the source's design: a thread owning
# kUnit contiguous elements, and a ticket behind full fences
CG_ALTERNATIVES = {
    "layout=thread-contiguous": {"e0": (
        "e0[j] = c * kChunk + ((long long)(j / (kUnit / V)) * kThreads"
        " + threadIdx.x) * kUnit + (j % (kUnit / V)) * V;")},
    "ticket=threadfence+atomicAdd": {"ticket": """    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
"""}}


def variant_sources(name: str, subst: tuple, variants: dict,
                    out: Path) -> dict:
    """{label: path of a copy of csrc/<name>.cu with ``subst`` formatted by
    ``variants[label]`` (a dict of the placeholders' values)}."""
    from repro_torch.kernels import build

    src = (build.CSRC / f"{name}.cu").read_text()
    for old, _ in subst:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/{name}.cu no longer holds {old!r}")
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for label, values in variants.items():
        text = src
        for old, new in subst:
            text = text.replace(old, new.format(**values))
        # nvcc reads commas and '=' in a file name as option syntax
        paths[label] = out / (name + "_" + re.sub(r"\W+", "_", label)
                              + ".cu")
        paths[label].write_text(text)
    return paths


def build_variants(sources: dict) -> dict:
    """{label: loaded library}, one nvcc per copy, all started together."""
    from repro_torch.kernels import build

    nvcc = build.find_nvcc()
    procs = {k: (subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", str(p.with_suffix(".so")), str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), p)
        for k, p in sources.items()}
    libs = {}
    for k, (proc, p) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {k} copy:\n{out}")
        libs[k] = ctypes.CDLL(str(p.with_suffix(".so")))
    return libs


def use(name: str, lib) -> None:
    """Point the wrappers at ``lib`` for csrc/<name>.cu."""
    from repro_torch.kernels import build

    build._LIBS[name] = lib
    build.entry.cache_clear()       # the wrappers' typed entry points


def measure(label: str, cases: dict, tol: float = 1e-4) -> None:
    """Time each (kernel call, plain result) of ``cases`` after holding the
    kernel against its plain version."""
    import torch
    from chip_smoke import log, rel_err, time_ms

    for k, (run, want) in cases.items():
        err = rel_err(run().double().cpu(), want.double().cpu())
        if err > tol:
            raise AssertionError(f"{label} {k}: {err} from the plain "
                                 f"version")
        log("lane-sweep", variant=label, kernel=k,
            ms=time_ms(run, torch.device("cuda")), vs_plain=err)


def sweep_spmv(m, dev) -> None:
    import torch
    from repro_torch.api import ExecutionConfig, plan
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ehyb_spmv as K

    variants = {f"G={g}": {"g": g, "u": 4} for g in WIDTHS}
    variants.update({f"G={g},er-unroll=8": {"g": g, "u": 8}
                     for g in (4, 8)})
    libs = build_variants(variant_sources(
        "ehyb_spmv", SPMV_SUBST, variants, build.BUILD_DIR / "lane_sweep"))
    default = build.load("ehyb_spmv")
    cfg = dict(partition_method="bfs")
    op = plan(m, execution=ExecutionConfig(format="ehyb_packed", **cfg),
              device=dev).bind(m)
    u = plan(m, execution=ExecutionConfig(format="ehyb", **cfg),
             device=dev).bind(m).obj
    o = op.obj
    gen = torch.Generator().manual_seed(0)
    x_new = op.to_space(torch.randn(m.n, generator=gen).to(dev))
    x16 = op.to_space(torch.randn((m.n, 16), generator=gen).to(dev))
    xp = x_new.reshape(o.n_parts, o.vec_size)
    stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
    er_t = (o.er_vals, o.er_cols, o.er_col_rows)
    plain = {
        "ehyb_fused": ref.ehyb_fused_stream_ref(
            x_new[:, None], u.ell_vals, u.ell_cols, u.col_rows,
            u.er_stream())[:, 0],
        "ehyb_packed_fused": ref.ehyb_packed_fused_stream_ref(
            x_new[:, None], *stair, o.er_stream(), o.vec_size)[:, 0],
        "ehyb_ell": ref.ehyb_ell_ref(xp[..., None], u.ell_vals,
                                     u.ell_cols, u.col_rows)[..., 0],
        "er": ref.er_live_ref(x_new[:, None], *er_t)[:, 0],
        "er_r16": ref.er_live_ref(x16, *er_t)}

    def cases(col_rows_u, names):
        calls = {
            "ehyb_fused": lambda: K.ehyb_fused(
                x_new, u.ell_vals, u.ell_cols, col_rows_u, u.er_stream()),
            "ehyb_packed_fused": lambda: K.ehyb_packed_fused(
                x_new, *stair, o.er_stream(), vec_size=o.vec_size),
            "ehyb_ell": lambda: K.ehyb_ell(xp, u.ell_vals, u.ell_cols,
                                           col_rows_u),
            "er": lambda: K.er(x_new, *er_t),
            "er_r16": lambda: K.er(x16, *er_t)}
        return {k: (calls[k], plain[k]) for k in names}

    try:
        for g, lib in libs.items():
            use("ehyb_spmv", lib)
            measure(g, cases(u.col_rows, plain))
        use("ehyb_spmv", default)
        measure("source", cases(u.col_rows, plain))
        measure("source, every row W wide",
                cases(torch.full_like(u.col_rows, u.vec_size),
                      ("ehyb_fused", "ehyb_ell")))
    finally:
        use("ehyb_spmv", default)


def sweep_spmm(m, dev) -> None:
    import torch
    from chip_smoke import spmm_cases
    from repro_torch.api import ExecutionConfig, plan
    from repro_torch.kernels import build

    variants = {f"group{g}-{'vj' if rm else 'jv'}-unroll{u}":
                {"g": g, "u": u, "row_major": "true" if rm else "false",
                 **SPMM_SOURCE}
                for g in WIDTHS for rm in (False, True) for u in (4, 8)
                if u == 4 or g == 16}
    variants.update({
        f"uniform-lanes{g}-threads{t}-unroll{u}":
        {"g": 4, "u": 4, "row_major": "true", **SPMM_SOURCE, "lanes": g,
         "threads": t, "uunroll": u}
        for g in (1, 2, 4, 8, 16) for t in (512, 1024) for u in (4, 8)})
    variants["launch-bounds-threads-only"] = {
        "g": 4, "u": 4, "row_major": "true", **SPMM_SOURCE,
        "launch_bounds": "__launch_bounds__(max_threads(KC, PACKED))"}
    libs = build_variants(variant_sources(
        "ehyb_spmm", SPMM_SUBST, variants, build.BUILD_DIR / "spmm_sweep"))
    default = build.load("ehyb_spmm")
    gen = torch.Generator().manual_seed(0)
    xb = torch.randn((m.n, 16), generator=gen).to(dev)
    sets = {}
    for k_plan, dtypes in ((16, (torch.float32, torch.bfloat16)),
                           (1, (torch.float32,))):
        ex = dict(partition_method="bfs", k=k_plan)
        pp = plan(m, execution=ExecutionConfig(format="ehyb_packed", **ex),
                  device=dev)
        pu = plan(m, execution=ExecutionConfig(format="ehyb", **ex),
                  device=dev)
        for dt in dtypes:
            op = pp.bind(m, dtype=dt)
            u = pu.bind(m, dtype=dt).obj
            x_new = op.to_space(xb.to(dt))
            cs = spmm_cases(op.obj, u, x_new)
            label = f"k{k_plan}/{str(dt).split('.')[1]}"
            sets[label] = {k: (run, plain()) for k, (run, plain)
                           in cs.items()}
    try:
        for v, lib in [*libs.items(), ("source", default)]:
            use("ehyb_spmm", lib)
            for label, cases in sets.items():
                tol = 1e-2 if "bfloat16" in label else 1e-4
                if v.startswith("uniform-"):
                    cases = {k: c for k, c in cases.items() if k in UNIFORM}
                measure(f"{v} {label}", cases, tol)
    finally:
        use("ehyb_spmm", default)


def sweep_cg(n: int, dev) -> None:
    import numpy as np
    import torch
    from chip_smoke import log, rel_err, time_ms
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import solver_step as S

    same = {"e0": CG_E0, "ticket": CG_TICKET}
    variants = {f"threads={t},elems={8 * u},blocks_per_sm={b}":
                {"t": t, "u": u, "b": b, **same}
                for t in (128, 256, 512) for u in (1, 2, 4) for b in (2, 4, 8)}
    variants.update({k: {"t": 256, "u": 2, "b": 4, **same, **v}
                     for k, v in CG_ALTERNATIVES.items()})
    libs = build_variants(variant_sources(
        "solver_step", CG_SUBST, variants, build.BUILD_DIR / "cg_sweep"))
    default = build.load("solver_step")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    alpha = torch.tensor(0.41, device=dev)

    def inputs(size, dt):
        rng = np.random.default_rng(size)
        vs = [torch.as_tensor(rng.standard_normal(size), dtype=dt,
                              device=dev) for _ in range(4)]
        return vs + [torch.as_tensor(rng.uniform(0.5, 1.5, size),
                                     dtype=torch.float32, device=dev)]

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = {(label, n): inputs(n, dt) for label, dt in dtypes.items()}
    cases = {k: (vs, ref.cg_update_ref(*vs, alpha))
             for k, vs in cases.items()}

    def run(v, label, size, vs, want, clean=False):
        got = S.fused_cg_update(*vs, alpha)
        vec_err = max(rel_err(g.double().cpu(), w.double().cpu())
                      for g, w in zip(got[:3], want[:3]))
        dot_err = max(abs(float(g) - float(w)) / max(abs(float(w)), 1e-30)
                      for g, w in zip(got[3:], want[3:]))
        if vec_err > (1e-6 if label == "float32" else 1e-2) \
                or dot_err > 1e-5:
            raise AssertionError(f"{v} {label} n={size}: vectors {vec_err}, "
                                 f"dots {dot_err} from the plain version")
        log("cg-sweep", variant=v, dtype=label, n=size,
            grid=S.launch_grid(size, sms, S.geometry(build.load(
                "solver_step"))), clean_l2=clean,
            ms=time_ms(lambda: S.fused_cg_update(*vs, alpha), dev,
                       clean=clean),
            vectors_rel=vec_err, dots_rel=dot_err)

    try:
        for v, lib in [*libs.items(), ("source", default)]:
            use("solver_step", lib)
            for (label, size), (vs, want) in cases.items():
                run(v, label, size, vs, want)
    finally:
        use("solver_step", default)
    # the source's constants: the fixed cost (n = 1), the streaming rate
    # (the slope over 1, 2, 4 and 8 times n), both L2 states, and beside it
    # torch.add (x + alpha·p: 12 B an element in fp32) under the same timer
    for label, dt in dtypes.items():
        for size in (1, n, 2 * n, 4 * n, 8 * n):
            vs = inputs(size, dt)
            want = ref.cg_update_ref(*vs, alpha)
            out = torch.empty_like(vs[0])
            for clean in (False, True):
                run("source", label, size, vs, want, clean)
                log("cg-yardstick", op="torch.add", dtype=label, n=size,
                    clean_l2=clean, ms=time_ms(lambda: torch.add(
                        vs[0], vs[2], alpha=0.41, out=out), dev,
                        clean=clean))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ehyb_lane_sweep: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--sweep", default="spmv,spmm,cg",
                    help="comma-separated: spmv, spmm, cg")
    ap.add_argument("--cg-n", type=int, default=789_888)
    args = ap.parse_args()

    from repro_torch.core.matrices import elasticity3d

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    names = args.sweep.split(",")
    m = elasticity3d(args.nx) if {"spmv", "spmm"} & set(names) else None
    sweeps = {"spmv": lambda: sweep_spmv(m, dev),
              "spmm": lambda: sweep_spmm(m, dev),
              "cg": lambda: sweep_cg(args.cg_n, dev)}
    for name in names:
        sweeps[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())

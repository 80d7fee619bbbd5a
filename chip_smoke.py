#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Six main paths, each driven with every kernel's launch count set to 0
just before it and read just after:

* the solve: preconditioned CG on ``elasticity3d(64)`` (786,432 rows, 61.7M
  nnz — a 3-dof 27-point stiffness matrix the size of ``audikw_1``),
  planned with the packed EHYB format and bfs partitions on the card, then
  ``op @ x``, ``op.solve(b, precond="spai")`` and the uniform-tile wrapper
  on the same build;
* the batched apply: the same matrix planned for 16 right-hand sides
  (``ExecutionConfig(k=16)``), then ``op @ X`` on 16 load cases,
  ``op.apply(X̃, space="permuted")``, the uniform-tile wrapper, the
  unfused ``use_er_kernel=False`` level on both layouts, K = 32 and bf16;
  then every SpMM kernel at K = 16 and 32 on this plan and on the
  solve's (bit-identical over two launches) and a NaN in X̃[0] through
  #7 and #9, which must reach only the rows whose CSR product reads it;
* the reliability path, on the solve's plan: the unfused level at one
  right-hand side on both layouts (fp32 and bf16, the ELL-only SpMV
  kernels), the fused SpMV rebuilt from the ELL-only kernel and the
  standalone ER kernel, the guard's fallback chain under fault injection
  (``chaos``: the native level fails, every kernel level fails, NaN
  output under a ``SolvePolicy``), and BiCGStab at full width;
* the refill, on the solve's plan: ``op.update_values`` of ``D A D`` (D a
  seeded positive diagonal: the same pattern, still SPD) in fp32 and bf16,
  timed end to end beside its host part, its upload and its scatter into
  the value tables on the card, then ``op2 @ x`` and the CG solve (against the plain path and a CPU solve of the
  same system); it checks that no partition, build, packing or
  grouping pass and no host refill ran and nothing was compiled or
  loaded, that every structural tensor is the one bound before, and that
  the refilled containers equal a fresh bind of ``D A D`` bit for bit;
* the train step, on the pruned llama3_2_1b FFN down projection: three
  SGD steps on the layer's bound values (forward, MSE loss, backward
  through the transpose plan's packed SpMM, ``layer.update_values``) and
  a fourth through ``torch.optim.SGD`` on ``layer.parameters()``, with
  the gradients held against a float64 oracle, the loss falling on every
  step and the forward after the optimizer's step against a float64
  oracle of the stepped weights;
* the default plan, right after the build: ``plan(m)`` with the default
  ``ExecutionConfig`` (every partition strategy priced at the card's
  geometry, every format ranked by modeled bytes, the pinned plan's bfs
  partition shared), then ``op @ x`` and ``op.solve(b, precond="spai")``;
  the measured pass (``mode="measure"``: the top candidates timed with
  CUDA events) at k = 1 and at k = 16 with the ``rhs_chunk`` sweep; the
  formats ``csr``, ``ell``, ``hyb`` and ``ehyb_bucketed`` pinned at full
  size (K = 1 and 16 against scipy, ``update_values`` of D A D
  bit-identical to a fresh bind), ``dense`` on the 8,192-row
  ``unstruct_8k``; and ``pruned_linear`` with its defaults on the
  llama3_2_1b down projection.  The winner must have the least modeled
  bytes, its solve must converge and its kernel launch.

Every apply goes through the plan's guard; outside the chaos phases the
script fails on any downgrade (``plan.degraded`` of every plan it built,
the ``guard.downgrade`` counter), so a kernel that does not build or launch
fails the run instead of degrading it.

Around them the script builds every kernel from the sources in the
checkout; holds each kernel against its plain PyTorch version and the
applies against ``scipy.sparse`` in float64; runs K = 16 on the solver's
k = 1 plan, an ER-free operator at full row count, and the pruned
llama3_2_1b FFN down projection (2048 x 8192, density 0.1, 16 tokens)
through ``pruned_linear``; sweeps every ``SUITE`` matrix in fp32 and bf16
through the SpMV, ELL-only, ER and SpMM kernels; times every kernel with
CUDA events; and prints one line of numbers per phase and the script's
seconds.  Any failed check raises and the exit
code is non-zero.

The last two lines are a JSON object of per-kernel numbers and the result
line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NX = 64                        # elasticity3d(64): 786,432 rows, 61.7M nnz
SEED = 0
K_RHS = 16                     # load cases applied to one stiffness matrix
D_MODEL, D_FF = 2048, 8192     # llama3_2_1b (src/repro/configs/llama3_2_1b.py)
TOKENS = 16
WARM_REPS = 5                  # warm fused solves timed (median kept)
SUITE_K = (4, 32)              # rhs widths of the SUITE sweep
BANDWIDTH = 3.35e12            # H100 SXM data sheet, bytes/s
FP32_PEAK = 67e12              # H100 SXM fp32 outside the tensor cores
# max|Δ| / max(max|y_ref|, 1).  Against scipy float64: the reference's
# conformance tolerance.  Kernel against its plain version on the same
# tables: both accumulate in fp32, so in bf16 they may differ only by the
# rounding of y — a few bf16 ulps (2^-8) of max|y|.
TOL = {"float32": 1e-4, "bfloat16": 1e-1}
# the batched apply against scipy float64: the reference's SpMM conformance
# tolerance in bf16 (tests/test_spmm.py)
SPMM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the ELL-only SpMV and ER kernels (#4-#6) against their plain versions:
# the same fp32 sums over at most a row's entries, so 1e-5 in fp32
REL_KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def log(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def rel_err(y, y_ref) -> float:
    import numpy as np

    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    return float(np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1.0))


def rel_to_largest(y, y_ref) -> float:
    """max|Δ| / max|y_ref|: for gradients, whose entries are far below 1."""
    import numpy as np

    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, device, reps: int = 20, warmup: int = 3,
            clean: bool = False) -> float:
    """Median CUDA-event time of ``fn`` in ms, L2 flushed before each launch
    (the solver streams far more than the 50 MB L2 between two calls).

    The flush writes 256 MB, which leaves L2 full of dirty lines: the timed
    kernel pays for writing back as many of them as it brings lines in.
    With ``clean=True`` the flush reads 256 MB instead, so L2 holds clean
    lines, as it does after the solver's SpMV, which reads ~400 MB.

    Before each start event the card spins for about half a millisecond
    (``torch.cuda._sleep``), so the host has enqueued ``fn``'s launches
    before the card reaches the start event: the events then bracket device
    work only, not the host's launch latency."""
    import torch

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=device)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def spmv_bound(n_pad: int, nnz_in: int, nnz_er: int, er_rows: int,
               itemsize: int, k: int = 1) -> tuple[float, str]:
    """Least time for Y = A X on this matrix with X of ``k`` columns: X read
    once, Y written once, each stored nonzero's value and column index read
    once (uint16 local columns in-partition, int32 global columns in ER, one
    int32 row index per live ER row); 2 flops per nonzero and column against
    the fp32 peak."""
    nbytes = (2 * n_pad * k * itemsize + nnz_in * (itemsize + 2)
              + nnz_er * (itemsize + 4) + er_rows * 4)
    t_bytes = nbytes / BANDWIDTH * 1e3
    t_ops = 2 * k * (nnz_in + nnz_er) / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def perm_csr(m, o, dev, in_part_only: bool = False):
    """``m`` in the permuted space of container ``o`` as a torch CSR tensor
    (fp32) — the library yardstick, timed and never called by the port.
    ``in_part_only`` keeps the entries whose row and column share a
    partition (what the ELL-only kernels compute)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    inv = o.inv_perm.cpu().numpy()
    rows = inv[np.repeat(np.arange(m.n), m.row_lengths())]
    cols = inv[m.indices]
    keep = (rows // o.vec_size == cols // o.vec_size) if in_part_only \
        else np.ones(len(rows), dtype=bool)
    a = sp.csr_matrix((m.data[keep], (rows[keep], cols[keep])),
                      shape=(o.n_pad, o.n_pad))
    return torch.sparse_csr_tensor(
        torch.as_tensor(a.indptr, dtype=torch.int64, device=dev),
        torch.as_tensor(a.indices, dtype=torch.int64, device=dev),
        torch.as_tensor(a.data, dtype=torch.float32, device=dev),
        size=a.shape, check_invariants=False)


def spmm_cases(o, u, x_new) -> dict:
    """{kernel: (kernel call, plain call)} for the four SpMM kernels on one
    build — ``o`` its packed container, ``u`` its uniform one — at the
    permuted-space batch ``x_new`` (n_pad, K)."""
    from repro_torch.kernels import ehyb_spmm as KM
    from repro_torch.kernels import ref

    xp = x_new.reshape(o.n_parts, o.vec_size, x_new.shape[1])
    stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
    return {
        "ehyb_fused_spmm": (
            lambda: KM.ehyb_fused_spmm(x_new, u.ell_vals, u.ell_cols,
                                       u.col_rows, u.er_stream()),
            lambda: ref.ehyb_fused_stream_ref(x_new, u.ell_vals, u.ell_cols,
                                              u.col_rows, u.er_stream())),
        "ehyb_packed_fused_spmm": (
            lambda: KM.ehyb_packed_fused_spmm(x_new, *stair, o.er_stream(),
                                              vec_size=o.vec_size),
            lambda: ref.ehyb_packed_fused_stream_ref(
                x_new, *stair, o.er_stream(), o.vec_size)),
        "ehyb_ell_spmm": (
            lambda: KM.ehyb_ell_spmm(xp, u.ell_vals, u.ell_cols,
                                     u.col_rows),
            lambda: ref.ehyb_ell_ref(xp, u.ell_vals, u.ell_cols,
                                     u.col_rows)),
        "ehyb_ell_packed_spmm": (
            lambda: KM.ehyb_ell_packed_spmm(xp, *stair),
            lambda: ref.ehyb_ell_packed_ref(xp, *stair)),
    }


def rel_cases(o, u, x_new) -> dict:
    """{kernel: (kernel call, plain call)} for the reliability path's three
    kernels on one build — ``o`` its packed container, ``u`` its uniform
    one — at the permuted-space vector ``x_new`` (n_pad,): the ELL-only
    SpMV kernels on (P, V) slices and the ER kernel on the global ER
    table's live prefixes."""
    from repro_torch.kernels import ehyb_spmv as K
    from repro_torch.kernels import ref

    xp = x_new.reshape(o.n_parts, o.vec_size)
    stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
    return {
        "ehyb_ell": (
            lambda: K.ehyb_ell(xp, u.ell_vals, u.ell_cols, u.col_rows),
            lambda: ref.ehyb_ell_ref(xp[..., None], u.ell_vals,
                                     u.ell_cols, u.col_rows)[..., 0]),
        "ehyb_ell_packed": (
            lambda: K.ehyb_ell_packed(xp, *stair),
            lambda: ref.ehyb_ell_packed_ref(xp[..., None], *stair)[..., 0]),
        "er": (
            lambda: K.er(x_new, o.er_vals, o.er_cols, o.er_col_rows),
            lambda: ref.er_live_ref(x_new[:, None], o.er_vals, o.er_cols,
                                    o.er_col_rows)[:, 0]),
    }


def ptxas_registers(report: str, names: tuple) -> dict:
    """{kernel instance: "registers/spill bytes"} of the kernels in
    ``ptxas -v``'s ``report`` whose mangled names contain one of
    ``names``."""
    import re

    out, fn, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and any(n in fn for n in names):
            out[fn] = f"{m.group(1)}/{spill}"
    return out


def check_cases(cases: dict, tol: float, what: str) -> dict:
    """Run each kernel and its plain version; raises past ``tol``.
    Returns {kernel: (relative error, max abs error)}."""
    import torch

    out = {}
    for name, (kern, plain) in cases.items():
        y, y_ref = kern(), plain()
        torch.cuda.synchronize()
        check(y.shape == y_ref.shape and y.dtype == y_ref.dtype
              and bool(torch.isfinite(y).all()), f"{what} {name} shape")
        err = rel_err(y.float().cpu(), y_ref.float().cpu())
        check(err <= tol, f"{what} {name}: {err} > {tol}")
        out[name] = (err, float((y.float() - y_ref.float()).abs().max()))
    return out


def resolve_guards(op) -> None:
    """Resolve both guards of ``op``'s plan.  Each probes its native level
    once (a kernel launch on a CUDA plan) on its first apply, so a path's
    launch counts are zeroed only after this."""
    import torch

    op @ torch.zeros(op.n, device=op.device)
    op.apply(torch.zeros(op.n_pad, device=op.device), space="permuted")


def check_healthy(plans: list, chaos_downgrades: int, phase: str) -> None:
    """Outside fault injection every plan runs its native level: no plan
    reports a downgrade and the downgrade counter holds only the chaos
    phases' own."""
    from repro_torch.core import counters

    bad = {f"{p.format}/{p.key[:8]}": p.degraded for p in plans
           if p.degraded}
    check(not bad, f"{phase}: unexpected downgrade {bad}")
    n = counters.COUNTERS.get("guard.downgrade", 0)
    check(n == chaos_downgrades,
          f"{phase}: guard.downgrade {n} outside the chaos phases")


def default_plan_phase(dev, m, plans: list, all_kernels: dict,
                       healthy) -> None:
    """The sixth main path (see the module docstring) on ``m``: the default
    plan, the measured pass, the four plain formats pinned at full size,
    ``dense`` on ``unstruct_8k`` and the pruned layer with its defaults.
    Every plan it makes joins ``plans``; raises on a failed check."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.api import ExecutionConfig, plan, pruned_linear
    from repro_torch.autotune.registry import get_format
    from repro_torch.core import counters
    from repro_torch.core.matrices import SUITE, SparseCSR
    from repro_torch.kernels import ref

    t_phase = time.perf_counter()
    failed0 = counters.COUNTERS.get("tune.candidate_failed", 0)
    a_sp = sp.csr_matrix((m.data, m.indices, m.indptr), shape=(m.n, m.n))
    rng = np.random.default_rng(SEED + 3)
    x_host = rng.standard_normal(m.n)
    b_host = rng.standard_normal(m.n)
    X_host = rng.standard_normal((m.n, K_RHS))
    x = torch.as_tensor(x_host, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b_host, dtype=torch.float32, device=dev)
    X = torch.as_tensor(X_host, dtype=torch.float32, device=dev)
    y_sp, Y_sp = a_sp @ x_host, a_sp @ X_host

    # -- the default plan: counts from 0, then op @ x and op.solve --------
    for fn in all_kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    p = plan(m, device=dev)
    t_plan = time.perf_counter() - t0
    pt, tu = p.partition_tuning, p.tuning
    for s in sorted(pt.modeled_bytes):
        log("default-plan-strategy", strategy=s,
            partition_s=round(pt.seconds[s], 3),
            modeled_bytes=pt.modeled_bytes[s],
            in_part_fraction=round(pt.in_part_fraction[s], 4))
    ranked = sorted(tu.modeled_bytes.items(), key=lambda kv: (kv[1], kv[0]))
    log("default-plan-formats", **dict(ranked))
    log("default-plan", strategy=p.partition_strategy, format=p.format,
        n_parts=p.n_parts, vec_size=p.vec_size, plan_s=round(t_plan, 3))
    check(p.format == ranked[0][0], "the default plan picks the format of "
          "least modeled bytes (every format is eligible on a card)")
    t0 = time.perf_counter()
    op = p.bind(m)
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t0
    y = op @ x
    torch.cuda.synchronize()
    after_apply = {k: f.launches for k, f in all_kernels.items()}
    t0 = time.perf_counter()
    res = op.solve(b, precond="spai", tol=1e-6)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = {k: f.launches for k, f in all_kernels.items() if f.launches}
    err = rel_err(y.cpu(), y_sp)
    b32 = b_host.astype(np.float32).astype(np.float64)
    true_res = float(np.linalg.norm(b32 - a_sp @ res.x.double().cpu().numpy())
                     / np.linalg.norm(b32))
    log("default-plan-path", bind_s=round(t_bind, 3), vs_scipy_f64=err,
        status=res.status, iters=int(res.iters), true_residual=true_res,
        solve_s=round(t_solve, 4), launches=launches, degraded=p.degraded)
    check(err <= 1e-4, f"default plan op @ x vs scipy: {err}")
    check(res.status == "converged" and true_res <= 1e-5,
          f"default plan solve: {res.status}, true residual {true_res}")
    check(launches.get("fused_cg_update", 0) > 0,
          "the default plan's solve went through the CG-step kernel")
    if get_format(p.format).kernel == "cuda":
        check(after_apply["ehyb_packed_fused"] > 0
              and launches["ehyb_packed_fused"] > after_apply[
                  "ehyb_packed_fused"],
              "op @ x and the solve went through the winner's kernel")
    check(p.degraded == {}, f"default plan degraded: {p.degraded}")
    # the byte model's partition against the pinned bfs plan of the build
    # phase (a cache hit), the same applies on the card
    ob = plan(m, execution=ExecutionConfig(format=p.format,
                                           partition_method="bfs"),
              device=dev).bind(m)
    vs_bfs = {}
    for name, o_ in (("default", op), ("bfs", ob)):
        for k_, v_ in (("k1", x), ("k16", X)):
            vn = o_.to_space(v_)
            vs_bfs[f"{name}_{k_}_ms"] = time_ms(
                lambda o_=o_, vn=vn: o_.apply(vn, space="permuted"), dev)
    log("default-plan-vs-bfs", format=p.format, **vs_bfs)
    plans.append(p)
    del op, ob, y, res

    # -- the measured pass: k = 1, then k = 16 with the rhs_chunk sweep ----
    t0 = time.perf_counter()
    pm = plan(m, execution=ExecutionConfig(mode="measure"), device=dev)
    t_m = time.perf_counter() - t0
    meas = pm.tuning.measured_s
    log("measured-plan", k=1, format=pm.format, seconds=round(t_m, 3),
        **{f"{f}_ms": s * 1e3 for f, s in meas.items()})
    check(pm.format == min(sorted(meas), key=meas.get),
          "the measured pass picks its fastest candidate")
    t0 = time.perf_counter()
    pk = plan(m, execution=ExecutionConfig(mode="measure", k=K_RHS),
              device=dev)
    t_k = time.perf_counter() - t0
    sweep = {dict(tok)["rhs_chunk"] if pk.format == "ehyb_packed" else
             str(tok): s * 1e3 for tok, s in (pk.tuning.sweep_s or {}).items()}
    for s_, b_ in sorted(pk.partition_tuning.modeled_bytes.items()):
        log("measured-plan-strategy", k=K_RHS, strategy=s_,
            partition_s=round(pk.partition_tuning.seconds[s_], 3),
            modeled_bytes=b_,
            in_part_fraction=round(pk.partition_tuning.in_part_fraction[s_],
                                   4))
    log("measured-plan", k=K_RHS, format=pk.format,
        strategy=pk.partition_strategy, n_parts=pk.n_parts,
        vec_size=pk.vec_size, seconds=round(t_k, 3),
        tuned=pk.tuned.to_dict(), sweep_ms=sweep,
        **{f"{f}_ms": s * 1e3 for f, s in pk.tuning.measured_s.items()})
    opk = pk.bind(m)
    err_k = rel_err((opk @ X).cpu(), Y_sp)
    check(err_k <= SPMM_TOL["float32"], f"measured k=16 plan: {err_k}")
    if pk.format == "ehyb_packed":
        o = opk.obj
        check(o.rhs_chunk == pk.tuned.rhs_chunk and len(sweep) == 3,
              "the swept rhs_chunk reaches the packed container")
        X_new = opk.to_space(X)
        n0 = all_kernels["ehyb_packed_fused_spmm"].launches
        Y_new = opk.apply(X_new, space="permuted")
        torch.cuda.synchronize()
        check(all_kernels["ehyb_packed_fused_spmm"].launches == n0 + 1,
              "op @ X under the tuned chunk went through #8")
        Y_plain = ref.ehyb_packed_fused_stream_ref(
            X_new, o.packed_vals, o.packed_cols, o.col_starts, o.col_rows,
            o.er_stream(), o.vec_size, o.has_er)
        err_p = rel_err(Y_new.cpu(), Y_plain.cpu())
        log("measured-plan-tuned-chunk", rhs_chunk=o.rhs_chunk,
            vs_plain=err_p, vs_scipy_f64=err_k)
        check(err_p <= KERNEL_TOL["float32"],
              f"#8 under the tuned chunk vs its plain version: {err_p}")
        del X_new, Y_new, Y_plain
    plans += [pm, pk]
    del opk

    # -- the plain formats pinned: K = 1 and 16, the refill ----------------
    dvec = 1.0 + 0.25 * np.random.default_rng(SEED + 3).random(m.n)
    rows = np.repeat(np.arange(m.n), m.row_lengths())
    m2 = SparseCSR(m.n, m.indptr, m.indices,
                   m.data * dvec[rows] * dvec[m.indices])
    dense_m = SUITE["unstruct_8k"]()
    cases = [(f, m, x, X, y_sp, Y_sp, m2)
             for f in ("csr", "ell", "hyb", "ehyb_bucketed")]
    rng_d = np.random.default_rng(SEED + 4)
    xd, Xd = rng_d.standard_normal(dense_m.n), \
        rng_d.standard_normal((dense_m.n, K_RHS))
    dense_sp = sp.csr_matrix((dense_m.data, dense_m.indices, dense_m.indptr),
                             shape=(dense_m.n, dense_m.n))
    cases.append(("dense", dense_m,
                  torch.as_tensor(xd, dtype=torch.float32, device=dev),
                  torch.as_tensor(Xd, dtype=torch.float32, device=dev),
                  dense_sp @ xd, dense_sp @ Xd,
                  SparseCSR(dense_m.n, dense_m.indptr, dense_m.indices,
                            2.0 * dense_m.data)))
    for fmt, mf, xf, Xf, yf, Yf, mf2 in cases:
        ex = ExecutionConfig(format=fmt, partition_method="bfs")
        t0 = time.perf_counter()
        pf = plan(mf, execution=ex, device=dev)
        of = pf.bind(mf)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        e1 = rel_err((of @ xf).cpu(), yf)
        e16 = rel_err((of @ Xf).cpu(), Yf)
        ms1 = time_ms(lambda: of @ xf, dev, reps=5, warmup=1)
        t0 = time.perf_counter()
        of2 = of.update_values(mf2)
        torch.cuda.synchronize()
        t_r = time.perf_counter() - t0
        fresh = plan(mf, execution=dataclasses.replace(
            ex, dtype=torch.float32), device=dev).bind(mf2)
        same = all(torch.equal(a, c) for a, c in zip(
            of2.obj.value_tables(), fresh.obj.value_tables()))
        shared = all(getattr(of2.obj, f.name) is getattr(of.obj, f.name)
                     for f in dataclasses.fields(of.obj)
                     if f.name not in type(of.obj).VALUE_FIELDS
                     and isinstance(getattr(of.obj, f.name),
                                    (torch.Tensor, tuple)))
        log("pinned-format", format=fmt, n=mf.n, bind_s=round(t_b, 3),
            rebind_s=round(t_r, 3), vs_scipy_f64_k1=e1,
            vs_scipy_f64_k16=e16, apply_ms=ms1, rebind_bit_identical=same,
            shared_structure=shared)
        check(e1 <= 1e-4 and e16 <= SPMM_TOL["float32"],
              f"{fmt}: op @ x {e1}, op @ X {e16} vs scipy")
        check(same and shared, f"{fmt}: the rebind equals a fresh bind and "
              f"shares the structure")
        plans += [pf, fresh.plan]
        del of, of2, fresh

    # -- the pruned layer with its defaults --------------------------------
    w = np.random.default_rng(SEED).normal(0.0, 0.02, (D_MODEL, D_FF))
    t0 = time.perf_counter()
    layer = pruned_linear(w, 0.1, device=dev)
    t_layer = time.perf_counter() - t0
    tok_host = rng.standard_normal((TOKENS, D_FF))
    with torch.no_grad():
        y_tok = layer(torch.as_tensor(tok_host, dtype=torch.float32,
                                      device=dev))
    keep = int(w.size * 0.1)
    thresh = np.partition(np.abs(w).ravel(), -keep)[-keep]
    w_pruned = np.where(np.abs(w) >= thresh, w, 0.0)
    err_l = rel_err(y_tok.cpu(), tok_host @ w_pruned.T)
    lt = layer.op.tuning
    log("pruned-default", format=layer.op.format,
        strategy=layer.op.plan.partition_strategy, setup_s=round(t_layer, 3),
        vs_f64=err_l, **{f"bytes_{f}": v for f, v in sorted(
            lt.modeled_bytes.items(), key=lambda kv: kv[1])})
    check(y_tok.shape == (TOKENS, D_MODEL) and err_l <= 1e-4,
          f"pruned layer with its defaults: {err_l}")
    plans.append(layer.op.plan)
    del layer

    failed = counters.COUNTERS.get("tune.candidate_failed", 0) - failed0
    check(failed == 0, f"tune.candidate_failed {failed}")
    healthy("default-plan")
    torch.cuda.empty_cache()
    log("default-plan-phase", seconds=round(time.perf_counter() - t_phase, 3))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    rows = run(torch.device("cuda"), NX)
    log("script", seconds=round(time.perf_counter() - t0, 3))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev, nx: int) -> list:
    """Every phase on ``dev`` with the main paths at ``elasticity3d(nx)``;
    raises on the first failed check.  Returns the rows of the kernels
    line."""
    import torch
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.api import (ExecutionConfig, PlanCache, SolvePolicy,
                                 chaos, plan, pruned_linear)
    from repro_torch.autotune.cost import matrix_key
    from repro_torch.autotune.registry import get_format
    from repro_torch.core import counters
    from repro_torch.core.ehyb import build_ehyb, er_stream
    from repro_torch.core.matrices import (SUITE, SparseCSR, elasticity3d,
                                           from_coo, unstructured)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import ehyb_spmm as KM
    from repro_torch.kernels import ehyb_spmv as K
    from repro_torch.kernels import solver_step as S
    from repro_torch.reliability import ReliabilityWarning
    from repro_torch.reliability.guard import reset_warned

    kernels = {"ehyb_fused": K.ehyb_fused,
               "ehyb_packed_fused": K.ehyb_packed_fused,
               "fused_cg_update": S.fused_cg_update}
    spmm_kernels = {"ehyb_fused_spmm": KM.ehyb_fused_spmm,
                    "ehyb_packed_fused_spmm": KM.ehyb_packed_fused_spmm,
                    "ehyb_ell_spmm": KM.ehyb_ell_spmm,
                    "ehyb_ell_packed_spmm": KM.ehyb_ell_packed_spmm}
    rel_kernels = {"ehyb_ell": K.ehyb_ell,
                   "ehyb_ell_packed": K.ehyb_ell_packed, "er": K.er}
    all_kernels = {**kernels, **spmm_kernels, **rel_kernels}
    plans = []                 # every plan built: none may degrade
    chaos_down = {"n": 0}      # guard.downgrade bumps of the chaos phases

    def healthy(phase: str) -> None:
        check_healthy(plans, chaos_down["n"], phase)

    # ---- 1. card -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    props = torch.cuda.get_device_properties(dev)
    log("card", name=repr(torch.cuda.get_device_name(0)), smi=repr(smi),
        sms=props.multi_processor_count,
        smem_optin=props.shared_memory_per_block_optin,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = build.build_all()
    log("kernels-built", seconds=round(time.perf_counter() - t0, 3),
        libraries=",".join(str(p.relative_to(ROOT)) for p in libs.values()))
    log("ptxas-registers-spills", **ptxas_registers(
        build.ptxas_report("ehyb_spmv"),
        ("ehyb_fused_kernel", "ehyb_packed_fused_kernel", "er_kernel")))
    log("ptxas-registers-spills-spmm", **ptxas_registers(
        build.ptxas_report("ehyb_spmm"), ("ehyb_spmm_kernel",)))
    log("ptxas-registers-spills-cg", **ptxas_registers(
        build.ptxas_report("solver_step"), ("cg_update_kernel",)))

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    m = elasticity3d(nx)
    t_gen = time.perf_counter() - t0
    cfg = dict(partition_method="bfs")
    t0 = time.perf_counter()
    p_packed = plan(m, execution=ExecutionConfig(format="ehyb_packed", **cfg),
                    device=dev)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = p_packed.bind(m)
    t_bind = time.perf_counter() - t0
    op_u = plan(m, execution=ExecutionConfig(format="ehyb", **cfg),
                device=dev).bind(m)           # same partition + host build
    plans += [p_packed, op_u.plan]
    e = p_packed.host_build(m)
    pk = e._packed
    nnz_er = int(m.nnz - e.nnz_in)
    er_live = int(e.fill_plan["n_er_live"])
    modeled = pk.bytes_moved(val_bytes=4, space="permuted", fused_er=True)
    check(op.plan.n_parts % props.multi_processor_count == 0
          and op.plan.vec_size % 32 == 0
          and op.plan.vec_size * 8 <= props.shared_memory_per_block_optin,
          "partitions sized by the card's SM count and shared memory")
    log("build", n=m.n, nnz=m.nnz, gen_s=round(t_gen, 3),
        plan_s=round(t_plan, 3), bind_s=round(t_bind, 3),
        ehyb_s=round(e.preprocess_seconds["total"], 3),
        pack_s=round(e.preprocess_seconds.get("pack", 0.0), 3),
        n_parts=op.plan.n_parts, vec_size=op.plan.vec_size,
        nnz_in=e.nnz_in, in_part_fraction=round(e.in_part_fraction, 4),
        er_rows=er_live, ell_width=e.ell_width, er_width=e.er_width,
        modeled_bytes_per_spmv=modeled["total"])

    # ---- 2b. the default plan: partition and format autotuned --------------
    default_plan_phase(dev, m, plans, all_kernels, healthy)

    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.standard_normal(m.n), dtype=torch.float32,
                        device=dev)
    b_host = rng.standard_normal(m.n)
    b = torch.as_tensor(b_host, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()

    # ---- main path: counts from 0, then op @ x, op.solve, uniform wrapper --
    resolve_guards(op)
    for fn in all_kernels.values():
        fn.launches = 0
    y = op @ x
    torch.cuda.synchronize()
    after_apply = {k: f.launches for k, f in kernels.items()}
    t0 = time.perf_counter()
    res = op.solve(b, precond="spai", tol=1e-6)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    after_solve = {k: f.launches for k, f in kernels.items()}
    y_u = ops.ehyb_spmv_fused(op_u.obj, x)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in kernels.items()}
    log("main-path", after_apply=after_apply, after_solve=after_solve,
        after_uniform=launches)
    check(all(f.launches == 0 for f in spmm_kernels.values()),
          "one right-hand side never reaches the SpMM kernels")
    check(after_apply == {"ehyb_fused": 0, "ehyb_packed_fused": 1,
                          "fused_cg_update": 0}, "op @ x went through "
          "the packed kernel once")
    check(after_solve["ehyb_packed_fused"] > 1
          and after_solve["fused_cg_update"] > 0, "op.solve went through "
          "the packed kernel and the CG-step kernel")
    check(all(v > 0 for v in launches.values()), "every kernel launched")
    levels = {k: g.level for k, g in p_packed._guards.items()}
    log("guard", levels=levels, degraded=p_packed.degraded)
    check(levels == {"apply": "ehyb_packed:native",
                     "permuted": "ehyb_packed:native"},
          "op @ x and the solve run the native level")
    healthy("main-path")

    # ---- 3. SpMV against the plain version and scipy -----------------------
    a_sp = sp.csr_matrix((m.data, m.indices, m.indptr), shape=(m.n, m.n))
    x_host = x.double().cpu().numpy()
    y_sp = a_sp @ x_host
    o = op.obj
    x_new = op.to_space(x)
    y_plain_new = ref.ehyb_packed_fused_stream_ref(
        x_new[:, None], o.packed_vals, o.packed_cols, o.col_starts,
        o.col_rows, o.er_stream(), o.vec_size, o.has_er)[:, 0]
    y_plain = op.from_space(y_plain_new)
    err_plain = rel_err(y.cpu(), y_plain.cpu())
    err_sp = rel_err(y.cpu(), y_sp)
    op16 = p_packed.bind(m, dtype=torch.bfloat16)
    err_sp16 = rel_err((op16 @ x).float().cpu(), y_sp)
    torch.cuda.synchronize()
    log("spmv", shape=tuple(y.shape), finite=bool(torch.isfinite(y).all()),
        vs_plain=err_plain, vs_scipy_f64=err_sp, bf16_vs_scipy_f64=err_sp16)
    check(y.shape == (m.n,) and bool(torch.isfinite(y).all()), "finite y")
    check(err_plain <= KERNEL_TOL["float32"] and err_sp <= TOL["float32"],
          "op @ x within 1e-4")
    check(err_sp16 <= TOL["bfloat16"], "bf16 op @ x within 1e-1")
    healthy("spmv")

    # ---- 4. kernel #1 on the same build ------------------------------------
    y_u_plain = op_u @ x                     # the registered plain apply
    err_u = rel_err(y_u.cpu(), y_u_plain.cpu())
    err_u_sp = rel_err(y_u.cpu(), y_sp)
    torch.cuda.synchronize()
    log("uniform", vs_plain=err_u, vs_scipy_f64=err_u_sp)
    check(err_u <= KERNEL_TOL["float32"] and err_u_sp <= TOL["float32"],
          "uniform kernel within 1e-4")
    u = op_u.obj
    healthy("uniform")

    # ---- 4b. #1, #2, #4, #5: bit-reproducible; the ER bytes they read ------
    xp_new = x_new.reshape(o.n_parts, o.vec_size)
    stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
    twice = {
        "ehyb_fused": lambda: K.ehyb_fused(x_new, u.ell_vals, u.ell_cols,
                                           u.col_rows, u.er_stream()),
        "ehyb_packed_fused": lambda: K.ehyb_packed_fused(
            x_new, *stair, o.er_stream(), vec_size=o.vec_size),
        "ehyb_ell": lambda: K.ehyb_ell(xp_new, u.ell_vals, u.ell_cols,
                                       u.col_rows),
        "ehyb_ell_packed": lambda: K.ehyb_ell_packed(xp_new, *stair),
        "er": lambda: K.er(x_new, o.er_vals, o.er_cols, o.er_col_rows),
    }
    same_bits = {k: bool(torch.equal(f(), f())) for k, f in twice.items()}
    er_p_shape = tuple(o.er_p_vals.shape)
    er_read = {
        # the compact stream: value + int32 column an entry, row pointer +
        # local row a live row, and the partition pointers
        "compact": nnz_er * 8 + er_live * 8 + (o.n_parts + 1) * 4,
        # the padded (P, E, We) tiles and the (P, E) rows read before
        "padded": o.er_p_vals.numel() * 8 + o.er_p_rows.numel() * 4}
    log("determinism-and-er-bytes", bit_identical=same_bits,
        er_tile=er_p_shape, er_live_rows=er_live, er_live_entries=nnz_er,
        er_bytes_now=er_read["compact"], er_bytes_before=er_read["padded"])
    check(all(same_bits.values()), "two launches give the same bits")
    check(int(o.er_s_vals.numel()) == nnz_er
          and int(o.er_s_rows.numel()) == er_live,
          "the compact stream holds every live ER entry and row")

    # ---- 5. batched main path: 16 load cases on a plan sized for them ------
    t0 = time.perf_counter()
    pb = plan(m, execution=ExecutionConfig(format="ehyb_packed", k=K_RHS,
                                           **cfg), device=dev)
    t_plan_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    opb = pb.bind(m)
    t_bind_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    opb_u = plan(m, execution=ExecutionConfig(format="ehyb", k=K_RHS, **cfg),
                 device=dev).bind(m)
    opb16 = pb.bind(m, dtype=torch.bfloat16)
    opb16_u = plan(m, execution=ExecutionConfig(format="ehyb", k=K_RHS,
                                                **cfg),
                   device=dev).bind(m, dtype=torch.bfloat16)
    plans += [pb, opb_u.plan]
    t_bind_more = time.perf_counter() - t0
    eb = pb.host_build(m)
    ob, ub = opb.obj, opb_u.obj
    nnz_er_b = int(m.nnz - eb.nnz_in)
    er_live_b = int(eb.fill_plan["n_er_live"])
    check(ob.n_parts % props.multi_processor_count == 0
          and ob.vec_size * K_RHS * 8 <= props.shared_memory_per_block_optin,
          "the batched plan holds 16 fp32 rhs columns a block")
    # the ER bytes the fused SpMM kernels read per rhs chunk on this plan:
    # the compact stream against the padded tiles they read before
    log("batched-er-bytes", er_tile=tuple(ob.er_p_vals.shape),
        er_live_rows=er_live_b, er_live_entries=nnz_er_b,
        er_bytes_now=nnz_er_b * 8 + er_live_b * 8 + (ob.n_parts + 1) * 4,
        er_bytes_before=ob.er_p_vals.numel() * 8 + ob.er_p_rows.numel() * 4,
        x_gathers_now=nnz_er_b, x_gathers_before=ob.er_p_vals.numel())
    log("batched-setup", plan_s=round(t_plan_b, 3), bind_s=round(t_bind_b, 3),
        uniform_and_bf16_binds_s=round(t_bind_more, 3),
        ehyb_s=round(eb.preprocess_seconds["total"], 3),
        n_parts=ob.n_parts, vec_size=ob.vec_size, nnz_in=eb.nnz_in,
        in_part_fraction=round(eb.in_part_fraction, 4), er_rows=er_live_b,
        ell_width=eb.ell_width, er_width=eb.er_width,
        er_tile=tuple(ob.er_p_vals.shape),
        modeled_bytes_per_spmm=eb._packed.bytes_moved(
            val_bytes=4, space="permuted", fused_er=True, k=K_RHS)["total"])

    xb_host = rng.standard_normal((m.n, K_RHS))    # 16 load cases
    xb = torch.as_tensor(xb_host, dtype=torch.float32, device=dev)
    xb32_host = rng.standard_normal((m.n, 2 * K_RHS))
    xb32 = torch.as_tensor(xb32_host, dtype=torch.float32, device=dev)
    xb_new = opb.to_space(xb)
    resolve_guards(opb)
    resolve_guards(opb_u)
    torch.cuda.synchronize()
    for fn in all_kernels.values():
        fn.launches = 0
    yb = opb @ xb
    yb_new = opb.apply(xb_new, space="permuted")
    yb_u_new = ops.ehyb_spmv_fused_permuted(ub, xb_new)
    yb_unf = {"packed": ops.ehyb_spmv_packed_permuted(ob, xb_new,
                                                      use_er_kernel=False),
              "uniform": ops.ehyb_spmv_fused_permuted(ub, xb_new,
                                                      use_er_kernel=False)}
    yb32 = opb @ xb32
    yb16 = opb16 @ xb
    torch.cuda.synchronize()
    launches_b = {k: f.launches for k, f in all_kernels.items()}
    log("batched-main-path", launches=launches_b)
    check(all(launches_b[k] > 0 for k in spmm_kernels),
          "the batched path went through every SpMM kernel")
    check(all(launches_b[k] == 0 for k in kernels),
          "the batched path launched no SpMV or CG-step kernel")

    ab_sp = a_sp @ xb_host
    checks_b = {
        "vs_scipy_f64": rel_err(yb.cpu(), ab_sp),
        "permuted_vs_scipy_f64": rel_err(opb.from_space(yb_new).cpu(), ab_sp),
        "uniform_vs_scipy_f64": rel_err(opb.from_space(yb_u_new).cpu(),
                                        ab_sp),
        "unfused_packed_vs_scipy_f64": rel_err(
            opb.from_space(yb_unf["packed"]).cpu(), ab_sp),
        "unfused_uniform_vs_scipy_f64": rel_err(
            opb.from_space(yb_unf["uniform"]).cpu(), ab_sp),
        "k32_vs_scipy_f64": rel_err(yb32.cpu(), a_sp @ xb32_host),
    }
    cols = torch.stack([opb @ xb[:, j] for j in range(K_RHS)], dim=1)
    err_cols = rel_err(yb.cpu(), cols.cpu())
    same = bool(torch.equal(opb.from_space(yb_new), yb))
    err_b16 = rel_err(yb16.float().cpu(), ab_sp)
    xb16_new = opb16.to_space(xb)
    o16 = opb16.obj
    err_b16_plain = rel_err(
        opb16.apply(xb16_new, space="permuted").float().cpu(),
        ref.ehyb_packed_fused_stream_ref(
            xb16_new, o16.packed_vals, o16.packed_cols, o16.col_starts,
            o16.col_rows, o16.er_stream(), o16.vec_size).float().cpu())
    spmm_b = check_cases(spmm_cases(ob, ub, xb_new), KERNEL_TOL["float32"],
                        "batched k=16 plan")
    spmm_b16 = check_cases(spmm_cases(o16, opb16_u.obj, xb16_new),
                          KERNEL_TOL["bfloat16"], "batched k=16 plan bf16")
    xb32_new = opb.to_space(xb32)
    spmm_b32 = check_cases(spmm_cases(ob, ub, xb32_new),
                           KERNEL_TOL["float32"], "batched K=32")
    log("batched", shape=tuple(yb.shape), **checks_b,
        vs_16_spmv_columns=err_cols, permuted_equals_original=same,
        bf16_vs_scipy_f64=err_b16, bf16_vs_plain=err_b16_plain,
        **{f"{k}_vs_plain": v[0] for k, v in spmm_b.items()},
        **{f"{k}_bf16_vs_plain": v[0] for k, v in spmm_b16.items()},
        **{f"{k}_k32_vs_plain": v[0] for k, v in spmm_b32.items()})
    check(yb.shape == (m.n, K_RHS) and bool(torch.isfinite(yb).all()),
          "finite Y of 16 columns")
    check(all(v <= SPMM_TOL["float32"] for v in checks_b.values()),
          "batched applies within 1e-4 of scipy")
    check(err_cols <= 1e-5, "batched apply within 1e-5 of 16 SpMVs")
    check(same, "op.apply(permuted) is op @ X")
    check(err_b16 <= SPMM_TOL["bfloat16"], "bf16 op @ X within 5e-2")
    check(err_b16_plain <= KERNEL_TOL["bfloat16"], "bf16 kernel vs plain")
    # 4b on the batched plan: two launches of each SpMM kernel give the
    # same bits, at K = 16 and K = 32
    same_bits_b = {}
    for kk, xk in ((K_RHS, xb_new), (2 * K_RHS, xb32_new)):
        for k, (kern, _) in spmm_cases(ob, ub, xk).items():
            same_bits_b[f"{k}_k{kk}"] = bool(torch.equal(kern(), kern()))
    log("determinism-batched", bit_identical=same_bits_b)
    check(all(same_bits_b.values()), "two SpMM launches give the same bits")
    healthy("batched")

    # ---- 5c. #7 and #9 read only live entries: a NaN in x_new[0] -----------
    # reaches the rows whose CSR product reads it (in-partition ones for
    # the ELL-only #9) and no other; a padded read (value 0, column 0)
    # would reach every row of partition 0 with a padded slot too
    inv_b = ub.inv_perm.cpu().numpy()
    col0 = int(np.flatnonzero(inv_b == 0)[0])
    reads = np.zeros(ub.n_pad, dtype=bool)
    reads[inv_b[np.repeat(np.arange(m.n), m.row_lengths())[
        m.indices == col0]]] = True
    ell_reads = reads.copy()
    ell_reads[ub.vec_size:] = False
    xnan = xb_new.clone()
    xnan[0] = float("nan")
    y_nan = {
        "ehyb_fused_spmm": (KM.ehyb_fused_spmm(
            xnan, ub.ell_vals, ub.ell_cols, ub.col_rows, ub.er_stream()),
            reads),
        "ehyb_ell_spmm": (KM.ehyb_ell_spmm(
            xnan.reshape(ub.n_parts, ub.vec_size, K_RHS), ub.ell_vals,
            ub.ell_cols, ub.col_rows).reshape(ub.n_pad, K_RHS), ell_reads)}
    widths0 = (torch.arange(ub.vec_size, device=dev)[:, None]
               < ub.col_rows[0][None, :]).sum(dim=1)
    padded0 = int((widths0 < ub.col_rows.shape[1]).sum())
    live_ok = {}
    for k, (yk, want) in y_nan.items():
        bad = ~np.isfinite(yk.float().cpu().numpy())
        live_ok[k] = bool(bad[want].all() and not bad[~want].any())
        log("live-read", kernel=k, csr_rows_reading_x0=int(want.sum()),
            nonfinite_rows=int(bad.any(axis=1).sum()),
            partition0_rows_with_padded_slots=padded0, live_only=live_ok[k])
    check(all(live_ok.values()), "#7 and #9 read only live entries")
    del y_nan, xnan

    # ---- 6. K = 16 on the solver's k = 1 plan (chunked re-sweep) -----------
    kc1 = KM.rhs_chunk_for(K_RHS, o.vec_size, 4, None,
                           props.shared_memory_per_block_optin)
    y1 = op @ xb
    x1_new = op.to_space(xb)
    spmm_1 = check_cases(spmm_cases(o, u, x1_new), KERNEL_TOL["float32"],
                        "k=1 plan at K=16")
    x1_32 = op.to_space(xb32)
    spmm_1_32 = check_cases(spmm_cases(o, u, x1_32), KERNEL_TOL["float32"],
                            "k=1 plan at K=32")
    same_bits_1 = {f"{k}_k{kk}": bool(torch.equal(kern(), kern()))
                   for kk, xk in ((K_RHS, x1_new), (2 * K_RHS, x1_32))
                   for k, (kern, _) in spmm_cases(o, u, xk).items()
                   if k in ("ehyb_fused_spmm", "ehyb_ell_spmm")}
    err_1 = rel_err(y1.cpu(), ab_sp)
    log("k1-plan-batched", n_parts=o.n_parts, vec_size=o.vec_size,
        rhs_chunk=kc1, passes_over_A=-(-K_RHS // kc1), vs_scipy_f64=err_1,
        **{f"{k}_vs_plain": v[0] for k, v in spmm_1.items()},
        **{f"{k}_k32_vs_plain": v[0] for k, v in spmm_1_32.items()},
        bit_identical=same_bits_1)
    check(err_1 <= SPMM_TOL["float32"], "k=1 plan op @ X within 1e-4")
    check(all(same_bits_1.values()), "two launches of #7 and #9 on the k=1 "
          "plan give the same bits")
    del yb32, xb32, xb32_new, x1_32, cols, opb16, opb16_u, o16, xb16_new
    healthy("k1-plan-batched")

    # ---- 7. an ER-free operator at full row count: A's diagonal ------------
    row_of = np.repeat(np.arange(m.n), m.row_lengths())
    on = row_of == m.indices
    dmat = from_coo(m.n, row_of[on], m.indices[on], m.data[on])
    exd = ExecutionConfig(format="ehyb_packed", k=K_RHS, **cfg)
    opd = plan(dmat, execution=exd, device=dev).bind(dmat)
    opd_u = plan(dmat, execution=ExecutionConfig(format="ehyb", k=K_RHS,
                                                 **cfg), device=dev).bind(dmat)
    before = {k: f.launches for k, f in spmm_kernels.items()}
    yd = opd @ xb
    yd_u = ops.ehyb_spmv_fused(opd_u.obj, xb)
    torch.cuda.synchronize()
    delta = {k: f.launches - before[k] for k, f in spmm_kernels.items()}
    yd_ref = dmat.data[:, None] * xb.double().cpu().numpy()
    err_d = (rel_err(yd.cpu(), yd_ref), rel_err(yd_u.cpu(), yd_ref))
    log("er-free", n=dmat.n, has_er=opd.obj.has_er, n_parts=opd.obj.n_parts,
        launches=delta, vs_f64=err_d[0], uniform_vs_f64=err_d[1])
    check(not opd.obj.has_er and not opd_u.obj.has_er, "diagonal is ER-free")
    check(delta == {"ehyb_fused_spmm": 0, "ehyb_packed_fused_spmm": 0,
                    "ehyb_ell_spmm": 1, "ehyb_ell_packed_spmm": 1},
          "ER-free K=16 goes to the ELL-only SpMM kernels")
    check(max(err_d) <= 1e-6, "diagonal apply within 1e-6")
    plans += [opd.plan, opd_u.plan]
    healthy("er-free")
    del opd, opd_u, yd, yd_u

    # ---- 8. pruned llama3_2_1b FFN down projection, 16 tokens --------------
    rng_w = np.random.default_rng(SEED)
    w = rng_w.normal(0.0, 0.02, (D_MODEL, D_FF))   # w_down.T: (d_out, d_in)
    t0 = time.perf_counter()
    layer = pruned_linear(w, 0.1, format="ehyb_packed",
                          partition_method="bfs", k=TOKENS, device=dev)
    t_layer = time.perf_counter() - t0
    tok_host = rng_w.standard_normal((TOKENS, D_FF))
    tok = torch.as_tensor(tok_host, dtype=torch.float32, device=dev)
    n0 = KM.ehyb_packed_fused_spmm.launches
    with torch.no_grad():            # inference: no graph on the values
        y_tok = layer(tok)
    torch.cuda.synchronize()
    layer_launches = KM.ehyb_packed_fused_spmm.launches - n0
    keep = int(w.size * 0.1)
    thresh = np.partition(np.abs(w).ravel(), -keep)[-keep]
    w_pruned = np.where(np.abs(w) >= thresh, w, 0.0)
    y_tok_ref = tok_host @ w_pruned.T                 # float64
    lo = layer.op.obj
    tok_new = layer.to_permuted(tok)
    y_tok_plain = layer.from_permuted(ref.ehyb_packed_fused_stream_ref(
        tok_new.T.contiguous(), lo.packed_vals, lo.packed_cols,
        lo.col_starts, lo.col_rows, lo.er_stream(), lo.vec_size).T)
    err_l = rel_err(y_tok.cpu(), y_tok_ref)
    err_lp = rel_err(y_tok.cpu(), y_tok_plain.cpu())
    w_dense = torch.as_tensor(w_pruned, dtype=torch.float32, device=dev)
    tok_new_t = tok_new.T.contiguous()
    layer_kernel_ms = time_ms(lambda: KM.ehyb_packed_fused_spmm(
        tok_new_t, lo.packed_vals, lo.packed_cols, lo.col_starts,
        lo.col_rows, lo.er_stream(), vec_size=lo.vec_size), dev)
    with torch.no_grad():
        layer_ms = time_ms(lambda: layer(tok), dev)
    dense_ms = time_ms(lambda: tok @ w_dense.T, dev)
    el = layer.ehyb
    log("pruned-layer", d_out=D_MODEL, d_in=D_FF, tokens=TOKENS,
        nnz=layer.csr.nnz, setup_s=round(t_layer, 3),
        n_parts=lo.n_parts, vec_size=lo.vec_size,
        in_part_fraction=round(el.in_part_fraction, 4),
        er_tile=tuple(lo.er_p_vals.shape),
        er_live_entries=int(lo.er_s_vals.numel()), launches=layer_launches,
        vs_f64=err_l, vs_plain=err_lp,
        layer_ms=layer_ms, kernel_ms=layer_kernel_ms, dense_matmul_ms=dense_ms,
        **{f"bytes_{k}": v for k, v in layer.bytes_vs_dense().items()})
    check(y_tok.shape == (TOKENS, D_MODEL)
          and bool(torch.isfinite(y_tok).all()), "layer output shape")
    check(err_l <= 1e-4 and err_lp <= KERNEL_TOL["float32"],
          "pruned layer within 1e-4")
    check(layer_launches == 1,
          "the layer went through the packed SpMM kernel once")
    plans.append(layer.op.plan)
    healthy("pruned-layer")
    del w_dense, tok_new, tok_new_t

    # ---- 9. every SUITE matrix, fp32 and bf16, SpMV and SpMM kernels ------
    worst = {}
    for name, make in SUITE.items():
        ms = make()
        xs = torch.as_tensor(np.random.default_rng(1).standard_normal(ms.n),
                             device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            opp = plan(ms, execution=ExecutionConfig(format="ehyb_packed",
                                                     **cfg),
                       device=dev).bind(ms, dtype=dtype)
            opu = plan(ms, execution=ExecutionConfig(format="ehyb", **cfg),
                       device=dev).bind(ms, dtype=dtype)
            xn = opp.to_space(xs)
            q, qu = opp.obj, opu.obj
            y_q = opp.apply(xn, space="permuted")
            y_qu = ops.ehyb_spmv_fused_permuted(qu, xn)
            errs = {
                "packed": rel_err(
                    y_q.float().cpu(),
                    ref.ehyb_packed_fused_stream_ref(
                        xn[:, None], q.packed_vals, q.packed_cols,
                        q.col_starts, q.col_rows, q.er_stream(), q.vec_size,
                        q.has_er)[:, 0].float().cpu()),
                "uniform": rel_err(
                    y_qu.float().cpu(),
                    ref.ehyb_fused_stream_ref(
                        xn[:, None], qu.ell_vals, qu.ell_cols, qu.col_rows,
                        qu.er_stream(), qu.has_er)[:, 0].float().cpu()),
                # the padded tiles' plain apply: the same product
                "uniform_vs_tiles": rel_err(
                    y_qu.float().cpu(),
                    opu.apply(xn, space="permuted").float().cpu()),
            }
            check(torch.equal(y_q, opp.apply(xn, space="permuted"))
                  and torch.equal(y_qu, ops.ehyb_spmv_fused_permuted(qu, xn)),
                  f"{name} {dtype}: two launches of #1 and #2 bit-identical")
            dn = str(dtype).split(".")[1]
            errs.update({k: v[0] for k, v in check_cases(
                rel_cases(q, qu, xn), REL_KERNEL_TOL[dn],
                f"{name} {dn}").items()})
            plans += [opp.plan, opu.plan]
            for kname, err in errs.items():
                check(err <= KERNEL_TOL[dn], f"{name} {dn} {kname}: {err}")
            for kk in SUITE_K:     # the four SpMM kernels, plans sized for K
                xk = torch.as_tensor(np.random.default_rng(kk).standard_normal(
                    (ms.n, kk)), device=dev)
                ex = dict(partition_method="bfs", k=kk)
                bp = plan(ms, execution=ExecutionConfig(format="ehyb_packed",
                                                        **ex),
                          device=dev).bind(ms, dtype=dtype)
                bu = plan(ms, execution=ExecutionConfig(format="ehyb", **ex),
                          device=dev).bind(ms, dtype=dtype)
                got = check_cases(spmm_cases(bp.obj, bu.obj,
                                            bp.to_space(xk)),
                                 KERNEL_TOL[dn], f"{name} {dn} K={kk}")
                for kname, v in got.items():
                    worst[(kname, dn)] = max(worst.get((kname, dn), 0.0),
                                             v[0])
                errs[f"spmm_k{kk}"] = max(v[0] for v in got.values())
                plans += [bp.plan, bu.plan]
            for kname in ("packed", "uniform", *rel_kernels):
                worst[(kname, dn)] = max(worst.get((kname, dn), 0.0),
                                         errs[kname])
            log("suite", matrix=name, dtype=dn, has_er=q.has_er,
                n_parts=q.n_parts, vec_size=q.vec_size,
                er_tile=tuple(q.er_p_vals.shape), **errs)
    torch.cuda.synchronize()
    log("suite-worst", **{f"{k}_{d}": v for (k, d), v in worst.items()})
    healthy("suite")

    # ---- 10. kernel #3 at the main path's shape ----------------------------
    # the solve runs CG in the permuted space: vectors of n_pad rows, laid
    # out by op.to_space, with the solve's own spai inverse diagonal; held
    # against the plain version in fp32, in bf16 (x, r, p, ap; minv stays
    # fp32) and with a NaN in the last element of r (what the solver's
    # divergence guard reads through rr)
    n = o.n_pad
    vecs = [op.to_space(torch.as_tensor(rng.standard_normal(m.n),
                                        dtype=torch.float32, device=dev))
            for _ in range(4)]
    vecs.append(torch.as_tensor(op.precond_inv_permuted("spai"),
                                dtype=torch.float32, device=dev))
    check(all(v.shape == (n,) for v in vecs), "CG vectors of n_pad rows")
    alpha = torch.tensor(0.41, dtype=torch.float32, device=dev)
    vecs16 = [v.bfloat16() for v in vecs[:4]] + [vecs[4]]
    vecs_nan = [v.clone() for v in vecs]
    vecs_nan[1][-1] = float("nan")
    cg_cases = {"float32": vecs, "bfloat16": vecs16, "nan_tail": vecs_nan}
    cg_err = {}
    for label, vs in cg_cases.items():
        got = S.fused_cg_update(*vs, alpha)
        want = ref.cg_update_ref(*vs, alpha)
        torch.cuda.synchronize()
        if label == "nan_tail":
            check(not bool(torch.isfinite(got[4]))
                  and all(torch.equal(torch.isfinite(g), torch.isfinite(w))
                          for g, w in zip(got, want)),
                  "a NaN in r's tail reaches rr as in the plain version")
            continue
        vec_err = max(rel_err(g.float().cpu(), w.float().cpu())
                      for g, w in zip(got[:3], want[:3]))
        vec_abs = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got[:3], want[:3]))
        dot_err = max(abs(float(g) - float(w)) / abs(float(w))
                      for g, w in zip(got[3:], want[3:]))
        again = S.fused_cg_update(*vs, alpha)
        same = bool(torch.equal(torch.stack(again[3:]), torch.stack(got[3:])))
        cg_err[label] = (vec_abs, vec_err, dot_err, same)
        check(vec_err <= (1e-6 if label == "float32" else 1e-2)
              and dot_err <= 1e-5 and same,
              f"CG-step kernel {label}: vectors {vec_err}, dots {dot_err}, "
              f"bit-identical dots {same}")
    geometry = S.geometry(build.load("solver_step"))
    cg_grid = S.launch_grid(n, props.multi_processor_count, geometry)
    cg_t = {}
    for label, itemsize in (("float32", 4), ("bfloat16", 2)):
        vs = cg_cases[label]
        # four vectors read and three written in the vectors' dtype, minv
        # read in fp32, alpha read and the two dots written; ~10 flops an
        # element against the fp32 peak
        nbytes = 7 * n * itemsize + 4 * n + 4 + 8
        tb = nbytes / BANDWIDTH * 1e3
        to = 10 * n / FP32_PEAK * 1e3
        cg_t[label] = (
            time_ms(lambda: S.fused_cg_update(*vs, alpha), dev),
            time_ms(lambda: ref.cg_update_ref(*vs, alpha), dev), None,
            max(tb, to), "bytes" if tb >= to else "operations")
        clean_ms = time_ms(lambda: S.fused_cg_update(*vs, alpha), dev,
                           clean=True)
        log("cg-update", dtype=label, n=n, grid=cg_grid,
            threads=geometry[0], elements_a_thread=geometry[1],
            blocks_per_sm=geometry[2], bytes=nbytes,
            kernel_ms=cg_t[label][0], kernel_clean_l2_ms=clean_ms,
            plain_ms=cg_t[label][1],
            bound_ms=cg_t[label][3], bound_by=cg_t[label][4],
            bound_share=round(cg_t[label][3] / cg_t[label][0], 4),
            bound_share_clean_l2=round(cg_t[label][3] / clean_ms, 4),
            vectors_abs=cg_err[label][0], vectors_rel=cg_err[label][1],
            dots_rel=cg_err[label][2], bit_identical=cg_err[label][3])
    vec_abs = cg_err["float32"][0]

    # ---- 11. the solve, fused against the plain path -----------------------
    x_sol = res.x.double().cpu().numpy()
    true_res = float(np.linalg.norm(b_host.astype(np.float32) - a_sp @ x_sol)
                     / np.linalg.norm(b_host.astype(np.float32)))
    res_plain = op_u.solve(b, precond="spai", tol=1e-6, fused_update=False)
    torch.cuda.synchronize()
    # warm solves: preconditioner diagonals memoized; the fused one
    # WARM_REPS times, its median read (one solve is a few ms of host
    # loop, and single readings spread by tens of percent)
    warm, warm_fused = {}, []
    for label, o_, fused, reps in (("fused", op, True, WARM_REPS),
                                   ("plain", op_u, False, 1)):
        for _ in range(reps):
            t0 = time.perf_counter()
            r_ = o_.solve(b, precond="spai", tol=1e-6, fused_update=fused)
            torch.cuda.synchronize()
            warm[label] = time.perf_counter() - t0
            if fused:
                warm_fused.append(warm[label])
            check(int(r_.iters) == int((res if fused else res_plain).iters),
                  "a warm solve repeats its iteration count")
    warm["fused"] = statistics.median(warm_fused)
    log("solve", iters=int(res.iters), status=res.status,
        residual=float(res.residual), true_residual_f64=true_res,
        first_wall_s=round(t_solve, 4), warm_wall_s=warm["fused"],
        warm_wall_min_s=min(warm_fused), warm_wall_max_s=max(warm_fused),
        warm_reps=len(warm_fused),
        plain_iters=int(res_plain.iters), plain_status=res_plain.status,
        plain_warm_wall_s=round(warm["plain"], 4))
    check(res.status == "converged" and res_plain.status == "converged",
          "both solves converged")
    check(abs(int(res.iters) - int(res_plain.iters)) <= 1, "iters within 1")
    check(true_res <= 1e-5, "true residual ≤ 1e-5")
    check(int(res.iters) == 6, "the solve takes 6 iterations")
    healthy("solve")

    # ---- 11a. where a warm solve's time goes: a profiler trace ------------
    # device busy time (the device's own activities in the trace: kernels,
    # copies, fills — not the host ops that launched them, nor the
    # profiler's buffer requests) against the unprofiled warm wall time
    # above; the trace's own wall time carries the profiler's host overhead
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        op.solve(b, precond="spai", tol=1e-6)
        torch.cuda.synchronize()
        t_traced = time.perf_counter() - t0
    dev_us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and ev.self_device_time_total > 0
              and not ev.key.startswith("Activity Buffer")}
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    log("solve-trace", warm_wall_ms=warm["fused"] * 1e3,
        traced_wall_ms=t_traced * 1e3, device_busy_ms=busy_ms,
        idle_share=(1 - busy_ms / (warm["fused"] * 1e3)) if busy_ms else
        "not measured",
        top_device_us={k[:60]: round(v, 1) for k, v in top},
        device_activities=sum(ev.count for ev in prof.key_averages()
                              if ev.key in dev_us))

    def true_residual(mat, rhs_host, r_):
        xs = r_.x.double().cpu().numpy()
        rhs = rhs_host.astype(np.float32).astype(np.float64)
        return float(np.linalg.norm(rhs - mat.spmv(xs)) / np.linalg.norm(rhs))

    def guard_warnings(caught):
        return [w for w in caught if w.category is ReliabilityWarning
                and "degraded" in str(w.message)]

    # ---- 11b. reliability main path: counts from 0, then the unfused level
    # at one rhs, ELL-only + ER, the chaos rungs and BiCGStab on the solve's
    # plan; the counts are read before any kernel is held against its plain
    # version
    t0 = time.perf_counter()
    op_u16 = plan(m, execution=ExecutionConfig(format="ehyb", **cfg),
                  device=dev).bind(m, dtype=torch.bfloat16)
    o16, u16 = op16.obj, op_u16.obj
    x16_new = op16.to_space(x)
    m_ns = unstructured(512, 10, seed=9)     # tests/test_reliability.py's
    op_ns = plan(m_ns, execution=ExecutionConfig(format="ehyb_packed", **cfg),
                 device=dev).bind(m_ns)
    b_ns_host = rng.standard_normal(m_ns.n)
    plans += [op_u16.plan, op_ns.plan]
    resolve_guards(op_ns)
    t_rel_setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    for fn in all_kernels.values():
        fn.launches = 0
    unf = {"packed": ops.ehyb_spmv_packed_permuted(o, x_new,
                                                   use_er_kernel=False),
           "uniform": ops.ehyb_spmv_fused_permuted(u, x_new,
                                                   use_er_kernel=False),
           "packed_bf16": ops.ehyb_spmv_packed_permuted(
               o16, x16_new, use_er_kernel=False),
           "uniform_bf16": ops.ehyb_spmv_fused_permuted(
               u16, x16_new, use_er_kernel=False)}
    torch.cuda.synchronize()
    after_unfused = {k: f.launches for k, f in all_kernels.items()}
    # the fused SpMV rebuilt from its halves: ELL-only (#5), then the ER
    # kernel's (#6) per-slot partials added at er_row_idx (the sublane
    # padding rows carry row 0 and write 0)
    y_er = K.er(x_new, o.er_vals, o.er_cols, o.er_col_rows)
    y_comp = K.ehyb_ell_packed(x_new.reshape(o.n_parts, o.vec_size),
                               o.packed_vals, o.packed_cols, o.col_starts,
                               o.col_rows).reshape(-1)
    y_comp.index_add_(0, o.er_row_idx.long(), y_er)
    torch.cuda.synchronize()
    # chaos rung 1: the native level fails -> the unfused level
    reset_warned()
    n_down0 = counters.COUNTERS.get("guard.downgrade", 0)
    c0 = {k: f.launches for k, f in all_kernels.items()}
    with warnings.catch_warnings(record=True) as w_native:
        warnings.simplefilter("always")
        with chaos(kernel_failure=("ehyb_packed:native",)) as cfg_native:
            res_native = op.solve(b, precond="spai", tol=1e-6)
            torch.cuda.synchronize()
            degraded_native = dict(p_packed.degraded)
    c1 = {k: f.launches for k, f in all_kernels.items()}
    op.apply(x_new, space="permuted")        # re-resolved after the block
    torch.cuda.synchronize()
    degraded_after = dict(p_packed.degraded)
    # chaos rung 2: every kernel level fails -> the reference level, on
    # the card
    with chaos(kernel_failure=("ehyb_packed:*",)) as cfg_all:
        y_reference = op @ x
        torch.cuda.synchronize()
        degraded_all = dict(p_packed.degraded)
    op @ x
    n_down = counters.COUNTERS.get("guard.downgrade", 0) - n_down0
    # chaos rung 3: NaN output under a SolvePolicy -> the solve ladder
    before = counters.snapshot()
    with warnings.catch_warnings(record=True) as w_nan:
        warnings.simplefilter("always")
        with chaos(nan_apply=True) as cfg_nan:
            t0 = time.perf_counter()
            res_nan = op.solve(b, precond="spai", tol=1e-6,
                               policy=SolvePolicy())
            torch.cuda.synchronize()
            t_nan = time.perf_counter() - t0
    after = counters.snapshot()
    chaos_down["n"] = counters.COUNTERS.get("guard.downgrade", 0)
    # BiCGStab at full width (first solve), and on a non-symmetric matrix
    t0 = time.perf_counter()
    res_bi = op.solve(b, method="bicgstab", precond="spai", tol=1e-6)
    torch.cuda.synchronize()
    t_bi_first = time.perf_counter() - t0
    res_ns = op_ns.solve(b_ns_host, method="bicgstab", precond="spai",
                         tol=1e-6)
    torch.cuda.synchronize()
    launches_r = {k: f.launches for k, f in all_kernels.items()}
    log("reliability-main-path", setup_s=round(t_rel_setup, 3),
        after_unfused=after_unfused, launches=launches_r)
    check(all(launches_r[k] > 0 for k in rel_kernels),
          "the reliability path went through #4, #5 and #6")
    check(after_unfused["ehyb_ell_packed"] == 2
          and after_unfused["ehyb_ell"] == 2
          and after_unfused["ehyb_packed_fused"] == 0
          and after_unfused["ehyb_fused"] == 0,
          "the unfused level at K = 1 launched each ELL-only kernel once "
          "per dtype and no fused kernel")

    # the unfused level against the fused kernels, scipy and bf16
    y_fused = {"packed": ops.ehyb_spmv_packed_permuted(o, x_new),
               "uniform": ops.ehyb_spmv_fused_permuted(u, x_new),
               "packed_bf16": ops.ehyb_spmv_packed_permuted(o16, x16_new),
               "uniform_bf16": ops.ehyb_spmv_fused_permuted(u16, x16_new)}
    errs_u = {}
    for k, y_k in unf.items():
        errs_u[f"{k}_vs_fused"] = rel_err(y_k.float().cpu(),
                                          y_fused[k].float().cpu())
        errs_u[f"{k}_vs_scipy_f64"] = rel_err(
            op.from_space(y_k).float().cpu(), y_sp)
    rel_chk = check_cases(rel_cases(o, u, x_new), REL_KERNEL_TOL["float32"],
                          "k=1 plan")
    rel_chk16 = check_cases(rel_cases(o16, u16, x16_new),
                            REL_KERNEL_TOL["bfloat16"], "k=1 plan bf16")
    log("unfused-k1", **errs_u,
        **{f"{k}_vs_plain": v[0] for k, v in rel_chk.items()},
        **{f"{k}_bf16_vs_plain": v[0] for k, v in rel_chk16.items()})
    for k in ("packed", "uniform"):
        check(errs_u[f"{k}_vs_fused"] <= 1e-5, f"unfused {k} vs fused")
        check(errs_u[f"{k}_vs_scipy_f64"] <= TOL["float32"],
              f"unfused {k} vs scipy")
        check(errs_u[f"{k}_bf16_vs_fused"] <= KERNEL_TOL["bfloat16"],
              f"unfused {k} bf16 vs fused")
        check(errs_u[f"{k}_bf16_vs_scipy_f64"] <= TOL["bfloat16"],
              f"unfused {k} bf16 vs scipy")

    err_comp = rel_err(y_comp.cpu(), y_fused["packed"].cpu())
    err_comp_sp = rel_err(op.from_space(y_comp).cpu(), y_sp)
    log("er", er_rows=tuple(o.er_vals.shape), live=nnz_er,
        er_vs_plain=rel_chk["er"][0], ell_plus_er_vs_fused=err_comp,
        ell_plus_er_vs_scipy_f64=err_comp_sp)
    check(err_comp <= 1e-5 and err_comp_sp <= TOL["float32"],
          "ELL-only + ER partials equal the fused SpMV")

    tr_native = true_residual(m, b_host, res_native)
    d_native = {k: c1[k] - c0[k] for k in all_kernels}
    log("chaos-native-fails", injected=dict(cfg_native.injected),
        degraded=degraded_native, degraded_after=degraded_after,
        launches=d_native, warnings=len(guard_warnings(w_native)),
        iters=int(res_native.iters), healthy_iters=int(res.iters),
        status=res_native.status, true_residual_f64=tr_native)
    check(cfg_native.injected["kernel:ehyb_packed:native"] > 0,
          "native-level fault fired")
    check(degraded_native == {"permuted": "ehyb_packed:unfused"},
          "the solve ran the unfused level")
    check(d_native["ehyb_ell_packed"] > 0
          and d_native["ehyb_packed_fused"] == 0,
          "under the fault #5 ran and #2 did not")
    check(len(guard_warnings(w_native)) == 1, "one ReliabilityWarning")
    check(res_native.status == "converged"
          and abs(int(res_native.iters) - int(res.iters)) <= 1
          and tr_native <= 1e-5, "the unfused-level solve converged")
    check(degraded_after == {}, "the guard is back on native after chaos")

    err_ref_lvl = rel_err(y_reference.cpu(), y_sp)
    log("chaos-all-kernels-fail", injected=dict(cfg_all.injected),
        degraded=degraded_all, device=str(y_reference.device),
        vs_scipy_f64=err_ref_lvl, downgrades=n_down)
    check(cfg_all.injected["kernel:ehyb_packed:native"] > 0
          and cfg_all.injected["kernel:ehyb_packed:unfused"] > 0,
          "both kernel-level faults fired")
    check(degraded_all == {"apply": "reference"}
          and y_reference.device.type == "cuda"
          and err_ref_lvl <= TOL["float32"],
          "the reference level ran on the card within 1e-4")
    check(n_down == 2, "one downgrade per faulted guard resolution")

    tr_nan = true_residual(m, b_host, res_nan)
    ladder = [str(w.message) for w in w_nan if "escalated" in str(w.message)]
    d_ctr = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("solver.restart", "solver.escalate_method",
                       "solver.escalate_reference", "solver.recovered")}
    log("chaos-nan", injected=dict(cfg_nan.injected), counters=d_ctr,
        ladder=repr(ladder), status=res_nan.status,
        iters=int(res_nan.iters), true_residual_f64=tr_nan,
        wall_s=round(t_nan, 4))
    check(cfg_nan.injected["nan"] > 0, "NaN fault fired")
    check(len(ladder) == 1 and "restart[cg], escalate:bicgstab, "
          "escalate:reference" in ladder[0], "the ladder's three stages")
    check(d_ctr == {"solver.restart": 1, "solver.escalate_method": 1,
                    "solver.escalate_reference": 1, "solver.recovered": 1},
          "one rung each, then recovered")
    check(res_nan.status == "converged" and tr_nan <= 1e-5,
          "the reference solve converged on the card")

    t0 = time.perf_counter()
    res_bi2 = op.solve(b, method="bicgstab", precond="spai", tol=1e-6)
    torch.cuda.synchronize()
    t_bi_warm = time.perf_counter() - t0
    tr_bi = true_residual(m, b_host, res_bi)
    tr_ns = true_residual(m_ns, b_ns_host, res_ns)
    log("bicgstab", iters=int(res_bi.iters), status=res_bi.status,
        residual=float(res_bi.residual), true_residual_f64=tr_bi,
        first_wall_s=round(t_bi_first, 4), warm_wall_s=round(t_bi_warm, 4),
        cg_iters=int(res.iters), cg_warm_wall_s=round(warm["fused"], 4),
        unstructured_iters=int(res_ns.iters),
        unstructured_status=res_ns.status, unstructured_true_residual=tr_ns)
    check(res_bi.status == "converged" and tr_bi <= 1e-5,
          "BiCGStab converged at full width")
    check(int(res_bi2.iters) == int(res_bi.iters),
          "a warm BiCGStab solve repeats its iteration count")
    check(res_ns.status == "converged" and tr_ns <= 1e-5,
          "BiCGStab converged on the non-symmetric matrix")
    healthy("reliability")
    del unf, y_fused, y_comp, y_reference, op_u16, x16_new

    # ---- 11c. refill main path: D A D on the solve's plan ------------------
    # the same pattern with new values, SPD still: D a seeded positive
    # diagonal.  op.update_values uploads the per-nnz values and scatters
    # them into new value tables on the card; the structure is shared, no
    # structure pass or host refill runs and nothing is built or loaded
    dvec = 1.0 + 0.25 * np.random.default_rng(SEED + 1).random(m.n)
    row_of_m = np.repeat(np.arange(m.n), m.row_lengths())
    m2 = SparseCSR(m.n, m.indptr, m.indices,
                   m.data * dvec[row_of_m] * dvec[m.indices])
    spec_p = get_format("ehyb_packed")
    value_fields = ("packed_vals", "ell_vals", "er_vals", "er_p_vals",
                    "er_s_vals")
    # the chaos phases moved the chaos epoch: resolve the plan's guards
    # (one probe each) before the counts start, so that a probe in the
    # counts below would be one the refill caused
    resolve_guards(op)
    before_r = counters.snapshot()
    for fn in all_kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op2 = op.update_values(m2)
    torch.cuda.synchronize()
    t_rebind = time.perf_counter() - t0
    t0 = time.perf_counter()
    op2_16 = op16.update_values(m2)
    torch.cuda.synchronize()
    t_rebind16 = time.perf_counter() - t0
    op2_u = op_u.update_values(m2)
    y2 = op2 @ x
    torch.cuda.synchronize()
    after_apply_r = {k: f.launches for k, f in kernels.items()}
    t0 = time.perf_counter()
    res2 = op2.solve(b, precond="spai", tol=1e-6)
    torch.cuda.synchronize()
    t_solve2 = time.perf_counter() - t0
    res2_plain = op2_u.solve(b, precond="spai", tol=1e-6,
                             fused_update=False)
    torch.cuda.synchronize()
    launches_rf = {k: f.launches for k, f in all_kernels.items()}
    after_r = counters.snapshot()
    work_r = {c: after_r.get(c, 0) - before_r.get(c, 0)
              for c in ("partition", "build_ehyb", "pack_staircase",
                        "group_er", "ehyb_refill", "kernels.nvcc",
                        "kernels.load")}
    # the same system on the CPU: the plain path, with the CPU plan's own
    # partition (the reference's cache sizing); after the counts, since
    # its plan partitions and builds
    t0 = time.perf_counter()
    res2_cpu = plan(m2, execution=ExecutionConfig(format="ehyb_packed",
                                                  **cfg),
                    device="cpu", cache=PlanCache()).bind(m2).solve(
        b_host, precond="spai", tol=1e-6)
    t_cpu2 = time.perf_counter() - t0
    # the rebind's parts, again on the same values: the host part (the
    # pattern check, the finiteness check and the values' key), the
    # upload of the per-nnz values and the scatter on the card
    t0 = time.perf_counter()
    p_packed._validate_bind(p_packed._as_csr(m2).data)
    matrix_key(m2, p_packed.key)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals2 = torch.from_numpy(m2.data).to(device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = p_packed._scatter(vals2)
    torch.cuda.synchronize()
    t_scatter = time.perf_counter() - t0
    del again, vals2
    o2 = op2.obj
    shared = {f.name: getattr(o2, f.name).data_ptr()
              == getattr(o, f.name).data_ptr()
              for f in dataclasses.fields(o2)
              if isinstance(getattr(o2, f.name), torch.Tensor)}
    shared16 = {f.name: getattr(op2_16.obj, f.name).data_ptr()
                == getattr(o16, f.name).data_ptr()
                for f in dataclasses.fields(o2)
                if isinstance(getattr(o2, f.name), torch.Tensor)}
    pos2 = torch.as_tensor(er_stream(e)["pos"], device=dev)
    stream_ok = all(bool(torch.equal(
        q.er_s_vals, q.er_p_vals.reshape(-1).index_select(0, pos2)))
        for q in (o2, op2_16.obj))
    a2_sp = sp.csr_matrix((m2.data, m2.indices, m2.indptr),
                          shape=(m.n, m.n))
    y2_sp = a2_sp @ x_host
    x2_new = op2.to_space(x)
    y2_plain = op2.from_space(ref.ehyb_packed_fused_stream_ref(
        x2_new[:, None], o2.packed_vals, o2.packed_cols, o2.col_starts,
        o2.col_rows, o2.er_stream(), o2.vec_size, o2.has_er)[:, 0])
    err2 = {"vs_scipy_f64": rel_err(y2.cpu(), y2_sp),
            "vs_plain": rel_err(y2.cpu(), y2_plain.cpu()),
            "bf16_vs_scipy_f64": rel_err((op2_16 @ x).float().cpu(), y2_sp)}
    x_sol2 = res2.x.double().cpu().numpy()
    b32 = b_host.astype(np.float32).astype(np.float64)
    tr2 = float(np.linalg.norm(b32 - a2_sp @ x_sol2) / np.linalg.norm(b32))
    # one fresh bind of D A D on the same partition, to hold the refill to
    t0 = time.perf_counter()
    e_fresh = build_ehyb(m2, part=p_packed.partition)
    fresh = {dt: spec_p.build(m2, {"ehyb": e_fresh,
                                   "tuned": p_packed.tuned}, dt, dev)
             for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    t_fresh = time.perf_counter() - t0
    same_fresh = {f"{dn}_{f}": bool(torch.equal(getattr(q, f),
                                                getattr(fresh[dt], f)))
                  for dn, dt, q in (("f32", torch.float32, o2),
                                    ("bf16", torch.bfloat16, op2_16.obj))
                  for f in value_fields if hasattr(q, f)}
    # the host refill (EHYB.refill of the cached build: what
    # plan.host_build runs for new values; no bind runs it) at full size,
    # held against the fresh build's host tables
    t0 = time.perf_counter()
    e2 = p_packed.host_build(m2)
    t_host_refill = time.perf_counter() - t0
    host_same = {
        "ell_vals": np.array_equal(e2.ell_vals, e_fresh.ell_vals),
        "er_vals": np.array_equal(e2.er_vals, e_fresh.er_vals),
        "er_p_vals": np.array_equal(e2._er_grouped["er_p_vals"],
                                    e_fresh._er_grouped["er_p_vals"]),
        "packed_vals": np.array_equal(e2._packed.packed_vals,
                                      e_fresh._packed.packed_vals)}
    del fresh, e_fresh, e2
    log("refill-main-path", launches=launches_rf, after_apply=after_apply_r,
        structure_work=work_r)
    log("refill", n=m.n, nnz=m.nnz, rebind_s=t_rebind,
        rebind_bf16_s=t_rebind16, host_s=t_host, upload_s=t_upload,
        scatter_s=t_scatter, bind_s=t_bind,
        fresh_build_and_upload_s=t_fresh, host_refill_s=t_host_refill,
        host_refill_bit_identical=all(host_same.values()),
        shared_structure=all(v for k, v in shared.items()
                             if k not in value_fields),
        new_value_tensors=[k for k, v in shared.items() if not v],
        bf16_shared_structure=all(v for k, v in shared16.items()
                                  if k not in value_fields),
        er_s_vals_gathered_at_pos=stream_ok,
        fresh_bind_bit_identical=all(same_fresh.values()), **err2)
    log("refill-solve", iters=int(res2.iters), status=res2.status,
        true_residual_f64=tr2, wall_s=t_solve2,
        plain_iters=int(res2_plain.iters), plain_status=res2_plain.status,
        cpu_iters=int(res2_cpu.iters), cpu_status=res2_cpu.status,
        cpu_plan_and_solve_s=t_cpu2, first_system_iters=int(res.iters))
    check(all(v == 0 for v in work_r.values()),
          f"a rebind runs no structure pass and no host refill, builds "
          f"and loads nothing: {work_r}")
    check(all(v for k, v in shared.items() if k not in value_fields)
          and all(v for k, v in shared16.items() if k not in value_fields),
          "every structural tensor is the same object after the refill")
    check(sorted(k for k, v in shared.items() if not v)
          == sorted(f for f in value_fields if hasattr(o2, f)),
          "the four value tensors are new")
    check(stream_ok, "er_s_vals is the new er_p_vals gathered at pos")
    check(all(same_fresh.values()), f"the refill equals a fresh bind bit "
          f"for bit: {same_fresh}")
    check(all(host_same.values()), f"the host refill equals a fresh build "
          f"bit for bit: {host_same}")
    check(err2["vs_scipy_f64"] <= TOL["float32"]
          and err2["vs_plain"] <= KERNEL_TOL["float32"]
          and err2["bf16_vs_scipy_f64"] <= TOL["bfloat16"],
          f"op2 @ x: {err2}")
    check(after_apply_r == {"ehyb_fused": 0, "ehyb_packed_fused": 1,
                            "fused_cg_update": 0},
          "op2 @ x went through the packed kernel once")
    check(launches_rf["ehyb_packed_fused"] > 1
          and launches_rf["fused_cg_update"] > 0,
          "the refilled solve went through #2 and #3")
    check(res2.status == res2_plain.status == res2_cpu.status
          == "converged" and tr2 <= 1e-5
          and abs(int(res2.iters) - int(res2_plain.iters)) <= 1
          and abs(int(res2.iters) - int(res2_cpu.iters)) <= 1,
          "CG with SPAI converged on D A D, within one iteration of the "
          "plain path on the card and of the CPU solve")
    check(op2.plan is p_packed and p_packed.degraded == {},
          "the refilled operator shares its plan, which runs native")
    healthy("refill")
    del op2, op2_16, op2_u, o2, y2, x2_new, y2_plain, a2_sp, m2

    # ---- 11d. train main path: 4 SGD steps on the layer's bound values ------
    # each step a forward, an MSE loss against a seeded target, a backward
    # (values and input gradients; Aᵀ ḡ on the transpose plan, #8 at 16
    # tokens) and layer.update_values of the stepped weights on the fixed
    # mask; the fourth steps through torch.optim.SGD on layer.parameters()
    # instead, and the next forward follows the stepped parameter (a
    # scatter of its values on the card).  The step size 1/L, with
    # L = 2 σ_max(X)² / (T·d_out) bounding the loss's curvature, makes
    # every step a descent step.
    target = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal(
        (TOKENS, D_MODEL)), dtype=torch.float32, device=dev)
    lr = TOKENS * D_MODEL / (2 * float(torch.linalg.matrix_norm(
        tok.double(), ord=2)) ** 2)
    c_l = layer.csr
    rows_l = np.repeat(np.arange(c_l.n), c_l.row_lengths())
    cols_l = c_l.indices.astype(np.int64)
    train = {"loss": [], "forward_ms": [], "backward_ms": [],
             "refill_ms": [], "grad_values_rel": [], "grad_x_rel": [],
             "backward_spmm_launches": [], "forward_spmm_launches": []}
    opt = torch.optim.SGD(layer.parameters(), lr=lr)
    before_train = counters.snapshot()
    for fn in all_kernels.values():
        fn.launches = 0
    for step in range(4):
        x_in = tok.clone().requires_grad_(True)
        n0 = KM.ehyb_packed_fused_spmm.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_l = layer(x_in)
        loss = ((y_l - target) ** 2).mean()
        torch.cuda.synchronize()
        train["forward_ms"].append((time.perf_counter() - t0) * 1e3)
        n1 = KM.ehyb_packed_fused_spmm.launches
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        train["backward_ms"].append((time.perf_counter() - t0) * 1e3)
        train["forward_spmm_launches"].append(n1 - n0)
        train["backward_spmm_launches"].append(
            KM.ehyb_packed_fused_spmm.launches - n1)
        train["loss"].append(float(loss.detach()))
        # float64 oracle of this step's backward: g = dL/dy from the step's
        # own y, grad_x = g W, grad_values[k] = Σ_t g[t, row_k] x[t, col_k]
        vals_now = layer.values.detach().double().cpu().numpy()
        g = 2.0 * (y_l.detach().double().cpu().numpy()
                   - target.double().cpu().numpy()) / (TOKENS * D_MODEL)
        w_now = np.zeros((D_MODEL, D_FF))
        w_now[rows_l, cols_l] = vals_now
        gv_ref = np.einsum("tk,tk->k", g[:, rows_l], tok_host[:, cols_l])
        train["grad_x_rel"].append(rel_to_largest(x_in.grad.cpu(),
                                                  g @ w_now))
        train["grad_values_rel"].append(
            rel_to_largest(layer.values.grad.cpu(), gv_ref))
        if step == 3:
            t0 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            t_opt = (time.perf_counter() - t0) * 1e3
            break
        w_next = np.zeros((D_MODEL, D_FF))
        w_next[rows_l, cols_l] = vals_now - lr * layer.values.grad.double() \
            .cpu().numpy()
        layer.values.grad = None
        t0 = time.perf_counter()
        layer.update_values(w_next)
        torch.cuda.synchronize()
        train["refill_ms"].append((time.perf_counter() - t0) * 1e3)
    # the forward after the optimizer's step rebinds the layer's operator
    # to the stepped parameter; held against float64 of those weights
    op_before = layer.op
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        y_final = layer(tok)
    torch.cuda.synchronize()
    t_rebind_fwd = (time.perf_counter() - t0) * 1e3
    train["loss"].append(float(((y_final - target) ** 2).mean()))
    w_final = np.zeros((D_MODEL, D_FF))
    w_final[rows_l, cols_l] = layer.values.detach().double().cpu().numpy()
    err_opt = rel_err(y_final.cpu(), tok_host @ w_final.T)
    launches_t = {k: f.launches for k, f in all_kernels.items()}
    after_train = counters.snapshot()
    work_t = {c: after_train.get(c, 0) - before_train.get(c, 0)
              for c in ("partition", "build_ehyb", "pack_staircase",
                        "group_er", "ehyb_refill", "kernels.nvcc",
                        "kernels.load")}
    tplan_l = layer.op.plan.transpose
    log("train-main-path", launches=launches_t, structure_work=work_t,
        lr=lr, transpose_is_own_plan=tplan_l is not layer.op.plan,
        transpose_n_parts=tplan_l.n_parts,
        transpose_vec_size=tplan_l.vec_size, optimizer_step_ms=t_opt,
        rebind_forward_ms=t_rebind_fwd, after_optimizer_vs_f64=err_opt,
        **train)
    check(all(b < a for a, b in zip(train["loss"], train["loss"][1:])),
          f"the loss falls on every step: {train['loss']}")
    check(max(train["grad_values_rel"] + train["grad_x_rel"]) <= 1e-4,
          "backward within 1e-4 of the float64 oracle")
    check(train["forward_spmm_launches"] == [1, 1, 1, 1]
          and train["backward_spmm_launches"] == [1, 1, 1, 1],
          "each forward and each backward launched #8 once")
    check(layer.op is not op_before and err_opt <= TOL["float32"],
          f"the forward after torch.optim.SGD's step follows the stepped "
          f"parameter: {err_opt} against float64")
    check(tplan_l is not layer.op.plan, "the pruned pattern's transpose "
          "is a plan of its own")
    # the first backward builds the transpose plan once (a partition and a
    # host build of Aᵀ's pattern); the refills and the optimizer's rebind
    # are device scatters, with no host refill
    check(work_t["partition"] <= 1 and work_t["build_ehyb"] <= 1
          and work_t["ehyb_refill"] == 0 and work_t["kernels.nvcc"] == 0
          and work_t["kernels.load"] == 0,
          f"the train loop's structure work: {work_t}")
    plans += [layer.op.plan, tplan_l]
    healthy("train")
    del layer, target, y_l, loss, x_in, w_now, w_next, w_final, y_final, \
        op_before, opt

    # ---- 12. times at the main paths' shapes -------------------------------
    a_t = perm_csr(m, o, dev)
    x_new2 = x_new[:, None]
    err_lib = rel_err((a_t @ x_new2)[:, 0].cpu(), y_plain_new.cpu())
    bound, bound_by = spmv_bound(o.n_pad, e.nnz_in, nnz_er, er_live, 4)
    lib_ms = time_ms(lambda: a_t @ x_new2, dev)
    t = {
        "ehyb_packed_fused": (
            time_ms(lambda: ops.ehyb_spmv_packed_permuted(o, x_new), dev),
            time_ms(lambda: ref.ehyb_packed_fused_stream_ref(
                x_new2, *stair, o.er_stream(), o.vec_size, o.has_er), dev),
            lib_ms, bound, bound_by),
        "ehyb_fused": (
            time_ms(lambda: ops.ehyb_spmv_fused_permuted(u, x_new), dev),
            time_ms(lambda: ref.ehyb_fused_stream_ref(
                x_new2, u.ell_vals, u.ell_cols, u.col_rows, u.er_stream(),
                u.has_er), dev),
            lib_ms, bound, bound_by),
    }
    t["fused_cg_update"] = cg_t["float32"]
    # the reliability path's kernels at the solve plan's shapes.  Library
    # yardsticks: torch CSR @ x of the in-partition entries (what #4 and #5
    # compute) and of the live ER entries, one CSR row per ER slot (what #6
    # computes)
    a_in = perm_csr(m, o, dev, in_part_only=True)
    lib_in_ms = time_ms(lambda: a_in @ x_new2, dev)
    del a_in
    er_w = e.er_width
    er_dst = e.fill_plan["er_dst"]
    er_sp = sp.csr_matrix((e.er_vals.reshape(-1)[er_dst],
                           (er_dst // er_w, e.er_cols.reshape(-1)[er_dst])),
                          shape=(e.er_rows, o.n_pad))
    er_t = torch.sparse_csr_tensor(
        torch.as_tensor(er_sp.indptr, dtype=torch.int64, device=dev),
        torch.as_tensor(er_sp.indices, dtype=torch.int64, device=dev),
        torch.as_tensor(er_sp.data, dtype=torch.float32, device=dev),
        size=er_sp.shape, check_invariants=False)
    err_lib_er = rel_err((er_t @ x_new2)[:, 0].cpu(), K.er(
        x_new, o.er_vals, o.er_cols, o.er_col_rows).cpu())
    lib_er_ms = time_ms(lambda: er_t @ x_new2, dev)

    def er_bound(r: int) -> tuple[float, str]:
        """#6 at r rhs columns: each live ER entry (8 B) once, x and the
        (Rr, r) output once; 2 flops an entry and column."""
        tb = (8 * nnz_er + (o.n_pad + e.er_rows) * 4 * r) / BANDWIDTH * 1e3
        to = 2 * r * nnz_er / FP32_PEAK * 1e3
        return max(tb, to), "bytes" if tb >= to else "operations"

    padded_er_ms = (e.er_rows * er_w * 8 + o.n_pad * 4 + e.er_rows * 4) \
        / BANDWIDTH * 1e3
    # what #6 reads now: each row's live prefix of values and of columns in
    # 32-byte sectors (row e starts at byte e * W * 4 of both tables), then
    # x and its output
    widths = np.bincount(er_dst // er_w, minlength=e.er_rows)
    first = np.arange(e.er_rows) * er_w * 4
    sectors = np.where(widths > 0,
                       (first + widths * 4 - 1) // 32 - first // 32 + 1, 0)
    er_read = 2 * 32 * int(sectors.sum()) + (o.n_pad + e.er_rows) * 4
    cases_r = rel_cases(o, u, x_new)
    bound_in = spmv_bound(o.n_pad, e.nnz_in, 0, 0, 4)
    for k in ("ehyb_ell", "ehyb_ell_packed"):
        t[k] = (time_ms(cases_r[k][0], dev), time_ms(cases_r[k][1], dev),
                lib_in_ms, *bound_in)
    t["er"] = (time_ms(cases_r["er"][0], dev), time_ms(cases_r["er"][1], dev),
               lib_er_ms, *er_bound(1))
    # #6 at R = 16 (the load cases on this plan), fp32 and bf16, beside
    # torch CSR @ X of the live ER entries
    x16_16 = x1_new.bfloat16()
    er16 = {"float32": (
        lambda: K.er(x1_new, o.er_vals, o.er_cols, o.er_col_rows),
        lambda: ref.er_live_ref(x1_new, o.er_vals, o.er_cols,
                                o.er_col_rows)),
        "bfloat16": (
        lambda: K.er(x16_16, o16.er_vals, o16.er_cols, o16.er_col_rows),
        lambda: ref.er_live_ref(x16_16, o16.er_vals, o16.er_cols,
                                o16.er_col_rows))}
    err16 = {dn: check_cases({"er": c}, REL_KERNEL_TOL[dn],
                             f"er R={K_RHS} {dn}")["er"][0]
             for dn, c in er16.items()}
    er16_ms = (time_ms(er16["float32"][0], dev),
               time_ms(er16["float32"][1], dev),
               time_ms(lambda: er_t @ x1_new, dev), *er_bound(K_RHS))
    same16 = bool(torch.equal(er16["float32"][0](), er16["float32"][0]()))
    check(same16, f"two launches of #6 at R={K_RHS} give the same bits")
    del er_t, x16_16
    # the largest partition's bytes against the mean: with one block a
    # partition and one partition an SM, the largest sets a floor of its
    # bytes over an SM's share of the card's rate (6 B an ELL entry, 12 B
    # an ER entry: value, column, x gather; x-slice and y 4 B a row each)
    s_host = er_stream(e)
    ell_part = pk.col_starts[:, -1].astype(np.int64) * 6 + o.vec_size * 8
    er_part = np.diff(s_host["row_ptr"][s_host["part_ptr"]]) * 12
    for label, part_bytes in (("ehyb_ell_packed", ell_part),
                              ("ehyb_packed_fused", ell_part + er_part)):
        log("partition-balance", kernel=label,
            max_mb=float(part_bytes.max()) / 1e6,
            median_mb=float(np.median(part_bytes)) / 1e6,
            mean_mb=float(part_bytes.mean()) / 1e6,
            floor_ms=float(part_bytes.max()) * o.n_parts / BANDWIDTH * 1e3)
    log("er-bound", bytes_needed=8 * nnz_er + (o.n_pad + e.er_rows) * 4,
        bound_ms=t["er"][3], bytes_read_now=er_read,
        bytes_read_now_ms=er_read / BANDWIDTH * 1e3,
        padded_table_bytes=e.er_rows * er_w * 8, padded_table_ms=padded_er_ms,
        library_vs_kernel=err_lib_er)
    log("time-er-r16", r=K_RHS, kernel_ms=er16_ms[0], plain_ms=er16_ms[1],
        library_ms=er16_ms[2], bound_ms=er16_ms[3], bound_by=er16_ms[4],
        bound_share=round(er16_ms[3] / er16_ms[0], 4), vs_plain=err16,
        bit_identical=same16)
    for k, (ms_k, ms_p, ms_l, bd, by) in t.items():
        log("time", kernel=k, kernel_ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
            bound_ms=bd, bound_by=by, bound_share=round(bd / ms_k, 4))
    log("modeled-bound", bytes_moved_total=modeled["total"],
        ms=modeled["total"] / BANDWIDTH * 1e3)
    log("library-check", torch_sparse_csr_vs_plain=err_lib)
    del a_t

    # the SpMM kernels at K = 16 on both plans; the batched plan's numbers
    # go into the kernels line.  Library yardstick: cuSPARSE SpMM through
    # torch's CSR @ dense, on all of A (fused kernels) or on its
    # in-partition entries (ELL-only kernels).
    t_spmm = {}
    for label, (po, pu, pe, xn) in (("k16", (ob, ub, eb, xb_new)),
                                    ("k1", (o, u, e, x1_new))):
        er_rows_p = int(pe.fill_plan["n_er_live"])
        lib = {}
        for part, in_only in (("all", False), ("in_part", True)):
            a_k = perm_csr(m, po, dev, in_part_only=in_only)
            lib[part] = time_ms(lambda: a_k @ xn, dev)
            del a_k
        bounds = {
            "all": spmv_bound(po.n_pad, pe.nnz_in, int(m.nnz - pe.nnz_in),
                              er_rows_p, 4, K_RHS),
            "in_part": spmv_bound(po.n_pad, pe.nnz_in, 0, 0, 4, K_RHS)}
        for k, (kern, plain) in spmm_cases(po, pu, xn).items():
            part = "in_part" if "_ell_" in k else "all"
            row = (time_ms(kern, dev), time_ms(plain, dev), lib[part],
                   *bounds[part])
            t_spmm[(label, k)] = row
            log("time-spmm", plan=label, n_parts=po.n_parts,
                vec_size=po.vec_size, k=K_RHS, kernel=k, kernel_ms=row[0],
                plain_ms=row[1], library_ms=row[2], bound_ms=row[3],
                bound_by=row[4], bound_share=round(row[3] / row[0], 4))
    for k in spmm_kernels:
        t[k] = t_spmm[("k16", k)]

    healthy("times")

    # ---- 13. kernels line + result -----------------------------------------
    y_u_new = ops.ehyb_spmv_fused_permuted(u, x_new)
    y_u_plain_new = op_u.apply(x_new, space="permuted")
    max_abs = {
        "ehyb_packed_fused": float((ops.ehyb_spmv_packed_permuted(o, x_new)
                                    - y_plain_new).abs().max()),
        "ehyb_fused": float((y_u_new - y_u_plain_new).abs().max()),
        "fused_cg_update": vec_abs,
        **{k: v[1] for k, v in spmm_b.items()},
    }
    launches.update({k: launches_b[k] for k in spmm_kernels})
    launches.update({k: launches_r[k] for k in rel_kernels})
    max_abs.update({k: v[1] for k, v in rel_chk.items()})
    # (route, source, replaces, device kernels per counted wrapper call)
    meta = {
        "ehyb_packed_fused": ("cuda", "src/repro_torch/csrc/ehyb_spmv.cu",
                              "src/repro/kernels/ehyb_spmv.py:261", 1),
        "ehyb_fused": ("cuda", "src/repro_torch/csrc/ehyb_spmv.cu",
                       "src/repro/kernels/ehyb_spmv.py:195", 1),
        "fused_cg_update": ("cuda", "src/repro_torch/csrc/solver_step.cu",
                            "src/repro/kernels/solver_step.py:62", 1),
        "ehyb_fused_spmm": ("cuda", "src/repro_torch/csrc/ehyb_spmm.cu",
                            "src/repro/kernels/ehyb_spmm.py:119", 1),
        "ehyb_packed_fused_spmm": ("cuda", "src/repro_torch/csrc/ehyb_spmm.cu",
                                   "src/repro/kernels/ehyb_spmm.py:231", 1),
        "ehyb_ell_spmm": ("cuda", "src/repro_torch/csrc/ehyb_spmm.cu",
                          "src/repro/kernels/ehyb_spmm.py:71", 1),
        "ehyb_ell_packed_spmm": ("cuda", "src/repro_torch/csrc/ehyb_spmm.cu",
                                 "src/repro/kernels/ehyb_spmm.py:185", 1),
        "ehyb_ell": ("cuda", "src/repro_torch/csrc/ehyb_spmv.cu",
                     "src/repro/kernels/ehyb_spmv.py:69", 1),
        "ehyb_ell_packed": ("cuda", "src/repro_torch/csrc/ehyb_spmv.cu",
                            "src/repro/kernels/ehyb_spmv.py:125", 1),
        "er": ("cuda", "src/repro_torch/csrc/ehyb_spmv.cu",
               "src/repro/kernels/ehyb_spmv.py:317", 1),
    }
    rows = []
    for k in all_kernels:
        route, source, replaces, per_call = meta[k]
        ms_k, ms_p, ms_l, bd, by = t[k]
        rows.append({"name": k, "route": route, "source": source,
                     "replaces": replaces, "launches": launches[k],
                     "kernels_per_launch": per_call,
                     "max_abs_err": max_abs[k], "ms": ms_k, "plain_ms": ms_p,
                     "bound_ms": bd, "bound_by": by, "library_ms": ms_l})
    torch.cuda.synchronize()
    return rows


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

The main path is the paper's workload at the scale of its FEM set:
preconditioned CG on ``elasticity3d(64)`` (786,432 rows, 61.7M nnz — a
3-dof 27-point stiffness matrix the size of ``audikw_1``), planned with the
packed EHYB format and bfs partitions on the card, then ``op @ x``,
``op.solve(b, precond="spai")`` and the uniform-tile wrapper on the same
build.  Around it the script builds every kernel from the sources in the
checkout, holds each kernel against its plain PyTorch version (and the
SpMV against ``scipy.sparse`` in float64), sweeps every ``SUITE`` matrix in
fp32 and bf16, times every kernel with CUDA events, and prints one line of
numbers per phase.  Any failed check raises and the exit code is non-zero.

The last two lines are a JSON object of per-kernel numbers and the result
line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NX = 64                        # elasticity3d(64): 786,432 rows, 61.7M nnz
SEED = 0
BANDWIDTH = 3.35e12            # H100 SXM data sheet, bytes/s
FP32_PEAK = 67e12              # H100 SXM fp32 outside the tensor cores
# max|Δ| / max(max|y_ref|, 1).  Against scipy float64: the reference's
# conformance tolerance.  Kernel against its plain version on the same
# tables: both accumulate in fp32, so in bf16 they may differ only by the
# rounding of y — a few bf16 ulps (2^-8) of max|y|.
TOL = {"float32": 1e-4, "bfloat16": 1e-1}
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def log(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def rel_err(y, y_ref) -> float:
    import numpy as np

    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    return float(np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1.0))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, device, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` in ms, L2 flushed before each launch
    (the solver streams far more than the 50 MB L2 between two calls)."""
    import torch

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
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
               itemsize: int) -> tuple[float, str]:
    """Least time for y = A x on this matrix: x read once, y written once,
    each stored nonzero's value and column index read once (uint16 local
    columns in-partition, int32 global columns in ER, one int32 row index
    per live ER row); 2 flops per nonzero against the fp32 peak."""
    nbytes = (2 * n_pad * itemsize + nnz_in * (itemsize + 2)
              + nnz_er * (itemsize + 4) + er_rows * 4)
    t_bytes = nbytes / BANDWIDTH * 1e3
    t_ops = 2 * (nnz_in + nnz_er) / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    run(torch.device("cuda"), NX)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev, nx: int) -> None:
    """Every phase on ``dev`` with the main path at ``elasticity3d(nx)``;
    raises on the first failed check."""
    import torch
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.api import ExecutionConfig, plan
    from repro_torch.core.matrices import SUITE, elasticity3d
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import ehyb_spmv as K
    from repro_torch.kernels import solver_step as S

    kernels = {"ehyb_fused": K.ehyb_fused,
               "ehyb_packed_fused": K.ehyb_packed_fused,
               "fused_cg_update": S.fused_cg_update}

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

    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.standard_normal(m.n), dtype=torch.float32,
                        device=dev)
    b_host = rng.standard_normal(m.n)
    b = torch.as_tensor(b_host, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()

    # ---- main path: counts from 0, then op @ x, op.solve, uniform wrapper --
    for fn in kernels.values():
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
    check(after_apply == {"ehyb_fused": 0, "ehyb_packed_fused": 1,
                          "fused_cg_update": 0}, "op @ x went through "
          "the packed kernel once")
    check(after_solve["ehyb_packed_fused"] > 1
          and after_solve["fused_cg_update"] > 0, "op.solve went through "
          "the packed kernel and the CG-step kernel")
    check(all(v > 0 for v in launches.values()), "every kernel launched")

    # ---- 3. SpMV against the plain version and scipy -----------------------
    a_sp = sp.csr_matrix((m.data, m.indices, m.indptr), shape=(m.n, m.n))
    x_host = x.double().cpu().numpy()
    y_sp = a_sp @ x_host
    o = op.obj
    x_new = op.to_space(x)
    y_plain_new = ref.ehyb_packed_fused_ref(
        x_new[:, None], o.packed_vals, o.packed_cols, o.col_starts,
        o.col_rows, o.er_p_vals, o.er_p_cols, o.er_p_rows, o.vec_size,
        o.has_er)[:, 0]
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

    # ---- 4. kernel #1 on the same build ------------------------------------
    y_u_plain = op_u @ x                     # the registered plain apply
    err_u = rel_err(y_u.cpu(), y_u_plain.cpu())
    err_u_sp = rel_err(y_u.cpu(), y_sp)
    torch.cuda.synchronize()
    log("uniform", vs_plain=err_u, vs_scipy_f64=err_u_sp)
    check(err_u <= KERNEL_TOL["float32"] and err_u_sp <= TOL["float32"],
          "uniform kernel within 1e-4")

    # ---- 5. every SUITE matrix, fp32 and bf16, both SpMV kernels -----------
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
            q, u = opp.obj, opu.obj
            errs = {
                "packed": rel_err(
                    opp.apply(xn, space="permuted").float().cpu(),
                    ref.ehyb_packed_fused_ref(
                        xn[:, None], q.packed_vals, q.packed_cols,
                        q.col_starts, q.col_rows, q.er_p_vals, q.er_p_cols,
                        q.er_p_rows, q.vec_size, q.has_er)[:, 0].float().cpu()),
                "uniform": rel_err(
                    ops.ehyb_spmv_fused_permuted(u, xn).float().cpu(),
                    opu.apply(xn, space="permuted").float().cpu()),
            }
            dn = str(dtype).split(".")[1]
            for kname, err in errs.items():
                check(err <= KERNEL_TOL[dn], f"{name} {dn} {kname}: {err}")
                worst[(kname, dn)] = max(worst.get((kname, dn), 0.0), err)
            log("suite", matrix=name, dtype=dn, has_er=q.has_er,
                n_parts=q.n_parts, vec_size=q.vec_size,
                er_tile=tuple(q.er_p_vals.shape), **errs)
    torch.cuda.synchronize()
    log("suite-worst", **{f"{k}_{d}": v for (k, d), v in worst.items()})

    # ---- 6. kernel #3 at the main path's shape -----------------------------
    # the solve runs CG in the permuted space: vectors of n_pad rows (not a
    # multiple of the Triton block, so the masked tail is held too), laid
    # out by op.to_space, with the solve's own spai inverse diagonal
    n = o.n_pad
    vecs = [op.to_space(torch.as_tensor(rng.standard_normal(m.n),
                                        dtype=torch.float32, device=dev))
            for _ in range(4)]
    vecs.append(torch.as_tensor(op.precond_inv_permuted("spai"),
                                dtype=torch.float32, device=dev))
    check(all(v.shape == (n,) for v in vecs), "CG vectors of n_pad rows")
    alpha = torch.tensor(0.41, dtype=torch.float32, device=dev)
    got = S.fused_cg_update(*vecs, alpha)
    want = ref.cg_update_ref(*vecs, alpha)
    torch.cuda.synchronize()
    vec_err = max(rel_err(g.cpu(), w.cpu()) for g, w in zip(got[:3], want[:3]))
    vec_abs = max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
    dot_err = max(abs(float(g) - float(w)) / abs(float(w))
                  for g, w in zip(got[3:], want[3:]))
    log("cg-update", n=n, tail=n % S._BLOCK, vectors_rel=vec_err,
        vectors_abs=vec_abs, dots_rel=dot_err)
    check(vec_err <= 1e-6 and dot_err <= 1e-5, "CG-step kernel tolerance")

    # ---- 7. the solve, fused against the plain path ------------------------
    x_sol = res.x.double().cpu().numpy()
    true_res = float(np.linalg.norm(b_host.astype(np.float32) - a_sp @ x_sol)
                     / np.linalg.norm(b_host.astype(np.float32)))
    res_plain = op_u.solve(b, precond="spai", tol=1e-6, fused_update=False)
    torch.cuda.synchronize()
    # warm solves: Triton compiled, preconditioner diagonals memoized
    warm = {}
    for label, o_, fused in (("fused", op, True), ("plain", op_u, False)):
        t0 = time.perf_counter()
        r_ = o_.solve(b, precond="spai", tol=1e-6, fused_update=fused)
        torch.cuda.synchronize()
        warm[label] = time.perf_counter() - t0
        check(int(r_.iters) == int((res if fused else res_plain).iters),
              "a warm solve repeats its iteration count")
    log("solve", iters=int(res.iters), status=res.status,
        residual=float(res.residual), true_residual_f64=true_res,
        first_wall_s=round(t_solve, 4), warm_wall_s=round(warm["fused"], 4),
        plain_iters=int(res_plain.iters), plain_status=res_plain.status,
        plain_warm_wall_s=round(warm["plain"], 4))
    check(res.status == "converged" and res_plain.status == "converged",
          "both solves converged")
    check(abs(int(res.iters) - int(res_plain.iters)) <= 1, "iters within 1")
    check(true_res <= 1e-5, "true residual ≤ 1e-5")

    # ---- 8. times at the main path's shapes --------------------------------
    u = op_u.obj
    rows_new = o.inv_perm.cpu().numpy()[np.repeat(np.arange(m.n),
                                                  m.row_lengths())]
    cols_new = o.inv_perm.cpu().numpy()[m.indices]
    a_perm = sp.csr_matrix((m.data, (rows_new, cols_new)),
                           shape=(o.n_pad, o.n_pad))
    a_t = torch.sparse_csr_tensor(
        torch.as_tensor(a_perm.indptr, dtype=torch.int64, device=dev),
        torch.as_tensor(a_perm.indices, dtype=torch.int64, device=dev),
        torch.as_tensor(a_perm.data, dtype=torch.float32, device=dev),
        size=a_perm.shape, check_invariants=False)
    x_new2 = x_new[:, None]
    err_lib = rel_err((a_t @ x_new2)[:, 0].cpu(), y_plain_new.cpu())
    bound, bound_by = spmv_bound(o.n_pad, e.nnz_in, nnz_er, er_live, 4)
    lib_ms = time_ms(lambda: a_t @ x_new2, dev)
    t = {
        "ehyb_packed_fused": (
            time_ms(lambda: ops.ehyb_spmv_packed_permuted(o, x_new), dev),
            time_ms(lambda: ref.ehyb_packed_fused_ref(
                x_new2, o.packed_vals, o.packed_cols, o.col_starts,
                o.col_rows, o.er_p_vals, o.er_p_cols, o.er_p_rows,
                o.vec_size, o.has_er), dev),
            lib_ms, bound, bound_by),
        "ehyb_fused": (
            time_ms(lambda: ops.ehyb_spmv_fused_permuted(u, x_new), dev),
            time_ms(lambda: ref.ehyb_fused_ref(
                x_new2, u.ell_vals, u.ell_cols, u.er_p_vals, u.er_p_cols,
                u.er_p_rows, u.has_er), dev),
            lib_ms, bound, bound_by),
    }
    cg_bytes = (5 + 3) * n * 4 + 4 + 8
    cg_bound_b = cg_bytes / BANDWIDTH * 1e3
    cg_bound_o = 10 * n / FP32_PEAK * 1e3
    t["fused_cg_update"] = (
        time_ms(lambda: S.fused_cg_update(*vecs, alpha), dev),
        time_ms(lambda: ref.cg_update_ref(*vecs, alpha), dev), None,
        max(cg_bound_b, cg_bound_o),
        "bytes" if cg_bound_b >= cg_bound_o else "operations")
    for k, (ms_k, ms_p, ms_l, bd, by) in t.items():
        log("time", kernel=k, kernel_ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
            bound_ms=bd, bound_by=by, bound_share=round(bd / ms_k, 4))
    log("modeled-bound", bytes_moved_total=modeled["total"],
        ms=modeled["total"] / BANDWIDTH * 1e3)
    log("library-check", torch_sparse_csr_vs_plain=err_lib)

    # ---- 9. kernels line + result ------------------------------------------
    y_u_new = ops.ehyb_spmv_fused_permuted(u, x_new)
    y_u_plain_new = op_u.apply(x_new, space="permuted")
    max_abs = {
        "ehyb_packed_fused": float((ops.ehyb_spmv_packed_permuted(o, x_new)
                                    - y_plain_new).abs().max()),
        "ehyb_fused": float((y_u_new - y_u_plain_new).abs().max()),
        "fused_cg_update": vec_abs,
    }
    # (route, source, replaces, device kernels per counted wrapper call:
    # the CG step runs its update pass, then its fixed-order sum of partials)
    meta = {
        "ehyb_packed_fused": ("cuda", "src/repro_torch/csrc/ehyb_spmv.cu",
                              "src/repro/kernels/ehyb_spmv.py:261", 1),
        "ehyb_fused": ("cuda", "src/repro_torch/csrc/ehyb_spmv.cu",
                       "src/repro/kernels/ehyb_spmv.py:195", 1),
        "fused_cg_update": ("triton", "src/repro_torch/kernels/solver_step.py",
                            "src/repro/kernels/solver_step.py:62", 2),
    }
    rows = []
    for k in ("ehyb_fused", "ehyb_packed_fused", "fused_cg_update"):
        route, source, replaces, per_call = meta[k]
        ms_k, ms_p, ms_l, bd, by = t[k]
        rows.append({"name": k, "route": route, "source": source,
                     "replaces": replaces, "launches": launches[k],
                     "kernels_per_launch": per_call,
                     "max_abs_err": max_abs[k], "ms": ms_k, "plain_ms": ms_p,
                     "bound_ms": bd, "bound_by": by, "library_ms": ms_l})
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

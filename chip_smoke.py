#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Two main paths, each driven with every kernel's launch count set to 0 just
before it and read just after:

* the solve: preconditioned CG on ``elasticity3d(64)`` (786,432 rows, 61.7M
  nnz — a 3-dof 27-point stiffness matrix the size of ``audikw_1``),
  planned with the packed EHYB format and bfs partitions on the card, then
  ``op @ x``, ``op.solve(b, precond="spai")`` and the uniform-tile wrapper
  on the same build;
* the batched apply: the same matrix planned for 16 right-hand sides
  (``ExecutionConfig(k=16)``), then ``op @ X`` on 16 load cases,
  ``op.apply(X̃, space="permuted")``, the uniform-tile wrapper, the
  unfused ``use_er_kernel=False`` level on both layouts, K = 32 and bf16.

Around them the script builds every kernel from the sources in the
checkout; holds each kernel against its plain PyTorch version and the
applies against ``scipy.sparse`` in float64; runs K = 16 on the solver's
k = 1 plan, an ER-free operator at full row count, and the pruned
llama3_2_1b FFN down projection (2048 x 8192, density 0.1, 16 tokens)
through ``pruned_linear``; sweeps every ``SUITE`` matrix in fp32 and bf16
through the SpMV and SpMM kernels; times every kernel with CUDA events; and
prints one line of numbers per phase.  Any failed check raises and the exit
code is non-zero.

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
K_RHS = 16                     # load cases applied to one stiffness matrix
D_MODEL, D_FF = 2048, 8192     # llama3_2_1b (src/repro/configs/llama3_2_1b.py)
TOKENS = 16
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
    (the solver streams far more than the 50 MB L2 between two calls).

    Before each start event the card spins for about half a millisecond
    (``torch.cuda._sleep``), so the host has enqueued ``fn``'s launches
    before the card reaches the start event: the events then bracket device
    work only, not the host's launch latency."""
    import torch

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
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
    er_u = (u.er_p_vals, u.er_p_cols, u.er_p_rows)
    er_o = (o.er_p_vals, o.er_p_cols, o.er_p_rows)
    stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
    return {
        "ehyb_fused_spmm": (
            lambda: KM.ehyb_fused_spmm(x_new, u.ell_vals, u.ell_cols, *er_u),
            lambda: ref.ehyb_fused_ref(x_new, u.ell_vals, u.ell_cols, *er_u)),
        "ehyb_packed_fused_spmm": (
            lambda: KM.ehyb_packed_fused_spmm(x_new, *stair, *er_o,
                                              vec_size=o.vec_size),
            lambda: ref.ehyb_packed_fused_ref(x_new, *stair, *er_o,
                                              o.vec_size)),
        "ehyb_ell_spmm": (
            lambda: KM.ehyb_ell_spmm(xp, u.ell_vals, u.ell_cols),
            lambda: ref.ehyb_ell_ref(xp, u.ell_vals, u.ell_cols)),
        "ehyb_ell_packed_spmm": (
            lambda: KM.ehyb_ell_packed_spmm(xp, *stair),
            lambda: ref.ehyb_ell_packed_ref(xp, *stair)),
    }


def check_spmm(cases: dict, tol: float, what: str) -> dict:
    """Run each SpMM kernel and its plain version; raises past ``tol``.
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

    from repro_torch.api import ExecutionConfig, plan, pruned_linear
    from repro_torch.core.matrices import SUITE, elasticity3d, from_coo
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import ehyb_spmm as KM
    from repro_torch.kernels import ehyb_spmv as K
    from repro_torch.kernels import solver_step as S

    kernels = {"ehyb_fused": K.ehyb_fused,
               "ehyb_packed_fused": K.ehyb_packed_fused,
               "fused_cg_update": S.fused_cg_update}
    spmm_kernels = {"ehyb_fused_spmm": KM.ehyb_fused_spmm,
                    "ehyb_packed_fused_spmm": KM.ehyb_packed_fused_spmm,
                    "ehyb_ell_spmm": KM.ehyb_ell_spmm,
                    "ehyb_ell_packed_spmm": KM.ehyb_ell_packed_spmm}
    all_kernels = {**kernels, **spmm_kernels}

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
    u = op_u.obj

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
    t_bind_more = time.perf_counter() - t0
    eb = pb.host_build(m)
    ob, ub = opb.obj, opb_u.obj
    nnz_er_b = int(m.nnz - eb.nnz_in)
    er_live_b = int(eb.fill_plan["n_er_live"])
    check(ob.n_parts % props.multi_processor_count == 0
          and ob.vec_size * K_RHS * 8 <= props.shared_memory_per_block_optin,
          "the batched plan holds 16 fp32 rhs columns a block")
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
        ref.ehyb_packed_fused_ref(
            xb16_new, o16.packed_vals, o16.packed_cols, o16.col_starts,
            o16.col_rows, o16.er_p_vals, o16.er_p_cols, o16.er_p_rows,
            o16.vec_size).float().cpu())
    spmm_b = check_spmm(spmm_cases(ob, ub, xb_new), KERNEL_TOL["float32"],
                        "batched k=16 plan")
    spmm_b16 = check_spmm(spmm_cases(o16, opb16_u.obj, xb16_new),
                          KERNEL_TOL["bfloat16"], "batched k=16 plan bf16")
    xb32_new = opb.to_space(xb32)
    spmm_b32 = check_spmm({"ehyb_packed_fused_spmm": spmm_cases(
        ob, ub, xb32_new)["ehyb_packed_fused_spmm"]}, KERNEL_TOL["float32"],
        "batched K=32")
    log("batched", shape=tuple(yb.shape), **checks_b,
        vs_16_spmv_columns=err_cols, permuted_equals_original=same,
        bf16_vs_scipy_f64=err_b16, bf16_vs_plain=err_b16_plain,
        **{f"{k}_vs_plain": v[0] for k, v in spmm_b.items()},
        **{f"{k}_bf16_vs_plain": v[0] for k, v in spmm_b16.items()},
        k32_packed_vs_plain=spmm_b32["ehyb_packed_fused_spmm"][0])
    check(yb.shape == (m.n, K_RHS) and bool(torch.isfinite(yb).all()),
          "finite Y of 16 columns")
    check(all(v <= SPMM_TOL["float32"] for v in checks_b.values()),
          "batched applies within 1e-4 of scipy")
    check(err_cols <= 1e-5, "batched apply within 1e-5 of 16 SpMVs")
    check(same, "op.apply(permuted) is op @ X")
    check(err_b16 <= SPMM_TOL["bfloat16"], "bf16 op @ X within 5e-2")
    check(err_b16_plain <= KERNEL_TOL["bfloat16"], "bf16 kernel vs plain")
    del yb32, xb32, xb32_new, cols, opb16, opb16_u, o16, xb16_new

    # ---- 6. K = 16 on the solver's k = 1 plan (chunked re-sweep) -----------
    kc1 = KM.rhs_chunk_for(K_RHS, o.vec_size, 4, None,
                           props.shared_memory_per_block_optin)
    y1 = op @ xb
    x1_new = op.to_space(xb)
    spmm_1 = check_spmm(spmm_cases(o, u, x1_new), KERNEL_TOL["float32"],
                        "k=1 plan at K=16")
    err_1 = rel_err(y1.cpu(), ab_sp)
    log("k1-plan-batched", n_parts=o.n_parts, vec_size=o.vec_size,
        rhs_chunk=kc1, passes_over_A=-(-K_RHS // kc1), vs_scipy_f64=err_1,
        **{f"{k}_vs_plain": v[0] for k, v in spmm_1.items()})
    check(err_1 <= SPMM_TOL["float32"], "k=1 plan op @ X within 1e-4")

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
    y_tok = layer(tok)
    torch.cuda.synchronize()
    layer_launches = KM.ehyb_packed_fused_spmm.launches - n0
    keep = int(w.size * 0.1)
    thresh = np.partition(np.abs(w).ravel(), -keep)[-keep]
    w_pruned = np.where(np.abs(w) >= thresh, w, 0.0)
    y_tok_ref = tok_host @ w_pruned.T                 # float64
    lo = layer.op.obj
    tok_new = layer.to_permuted(tok)
    y_tok_plain = layer.from_permuted(ref.ehyb_packed_fused_ref(
        tok_new.T.contiguous(), lo.packed_vals, lo.packed_cols,
        lo.col_starts, lo.col_rows, lo.er_p_vals, lo.er_p_cols,
        lo.er_p_rows, lo.vec_size).T)
    err_l = rel_err(y_tok.cpu(), y_tok_ref)
    err_lp = rel_err(y_tok.cpu(), y_tok_plain.cpu())
    w_dense = torch.as_tensor(w_pruned, dtype=torch.float32, device=dev)
    tok_new_t = tok_new.T.contiguous()
    layer_kernel_ms = time_ms(lambda: KM.ehyb_packed_fused_spmm(
        tok_new_t, lo.packed_vals, lo.packed_cols, lo.col_starts,
        lo.col_rows, lo.er_p_vals, lo.er_p_cols, lo.er_p_rows,
        vec_size=lo.vec_size), dev)
    layer_ms = time_ms(lambda: layer(tok), dev)
    dense_ms = time_ms(lambda: tok @ w_dense.T, dev)
    el = layer.ehyb
    log("pruned-layer", d_out=D_MODEL, d_in=D_FF, tokens=TOKENS,
        nnz=layer.csr.nnz, setup_s=round(t_layer, 3),
        n_parts=lo.n_parts, vec_size=lo.vec_size,
        in_part_fraction=round(el.in_part_fraction, 4),
        er_tile=tuple(lo.er_p_vals.shape),
        launches=layer_launches, vs_f64=err_l, vs_plain=err_lp,
        layer_ms=layer_ms, kernel_ms=layer_kernel_ms, dense_matmul_ms=dense_ms,
        **{f"bytes_{k}": v for k, v in layer.bytes_vs_dense().items()})
    check(y_tok.shape == (TOKENS, D_MODEL)
          and bool(torch.isfinite(y_tok).all()), "layer output shape")
    check(err_l <= 1e-4 and err_lp <= KERNEL_TOL["float32"],
          "pruned layer within 1e-4")
    check(layer_launches == 1,
          "the layer went through the packed SpMM kernel once")
    del layer, w_dense, tok_new, tok_new_t

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
            errs = {
                "packed": rel_err(
                    opp.apply(xn, space="permuted").float().cpu(),
                    ref.ehyb_packed_fused_ref(
                        xn[:, None], q.packed_vals, q.packed_cols,
                        q.col_starts, q.col_rows, q.er_p_vals, q.er_p_cols,
                        q.er_p_rows, q.vec_size, q.has_er)[:, 0].float().cpu()),
                "uniform": rel_err(
                    ops.ehyb_spmv_fused_permuted(qu, xn).float().cpu(),
                    opu.apply(xn, space="permuted").float().cpu()),
            }
            dn = str(dtype).split(".")[1]
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
                got = check_spmm(spmm_cases(bp.obj, bu.obj,
                                            bp.to_space(xk)),
                                 KERNEL_TOL[dn], f"{name} {dn} K={kk}")
                for kname, v in got.items():
                    worst[(kname, dn)] = max(worst.get((kname, dn), 0.0),
                                             v[0])
                errs[f"spmm_k{kk}"] = max(v[0] for v in got.values())
            for kname in ("packed", "uniform"):
                worst[(kname, dn)] = max(worst.get((kname, dn), 0.0),
                                         errs[kname])
            log("suite", matrix=name, dtype=dn, has_er=q.has_er,
                n_parts=q.n_parts, vec_size=q.vec_size,
                er_tile=tuple(q.er_p_vals.shape), **errs)
    torch.cuda.synchronize()
    log("suite-worst", **{f"{k}_{d}": v for (k, d), v in worst.items()})

    # ---- 10. kernel #3 at the main path's shape ----------------------------
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

    # ---- 11. the solve, fused against the plain path -----------------------
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

    # ---- 12. times at the main paths' shapes -------------------------------
    a_t = perm_csr(m, o, dev)
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
    # (route, source, replaces, device kernels per counted wrapper call:
    # the CG step runs its update pass, then its fixed-order sum of partials)
    meta = {
        "ehyb_packed_fused": ("cuda", "src/repro_torch/csrc/ehyb_spmv.cu",
                              "src/repro/kernels/ehyb_spmv.py:261", 1),
        "ehyb_fused": ("cuda", "src/repro_torch/csrc/ehyb_spmv.cu",
                       "src/repro/kernels/ehyb_spmv.py:195", 1),
        "fused_cg_update": ("triton", "src/repro_torch/kernels/solver_step.py",
                            "src/repro/kernels/solver_step.py:62", 2),
        "ehyb_fused_spmm": ("cuda", "src/repro_torch/csrc/ehyb_spmm.cu",
                            "src/repro/kernels/ehyb_spmm.py:119", 1),
        "ehyb_packed_fused_spmm": ("cuda", "src/repro_torch/csrc/ehyb_spmm.cu",
                                   "src/repro/kernels/ehyb_spmm.py:231", 1),
        "ehyb_ell_spmm": ("cuda", "src/repro_torch/csrc/ehyb_spmm.cu",
                          "src/repro/kernels/ehyb_spmm.py:71", 1),
        "ehyb_ell_packed_spmm": ("cuda", "src/repro_torch/csrc/ehyb_spmm.cu",
                                 "src/repro/kernels/ehyb_spmm.py:185", 1),
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
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

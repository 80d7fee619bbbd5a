#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Thirteen main paths, each driven with every kernel's launch count set to 0
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
* the default plan, right after the build, on ``elasticity3d(40)``
  (192,000 rows; the solve's 786k-row matrix took ~300 s here, most of it
  ranking partition strategies): ``plan(m)`` with the default
  ``ExecutionConfig`` (every partition strategy priced at the card's
  geometry, every format ranked by modeled bytes), then ``op @ x`` and
  ``op.solve(b, precond="spai")``;
  the measured pass (``mode="measure"``: the top candidates timed with
  CUDA events) at k = 1 and at k = 16 with the ``rhs_chunk`` sweep; the
  formats ``csr``, ``ell``, ``hyb`` and ``ehyb_bucketed`` pinned on the
  same matrix (K = 1 and 16 against scipy, ``update_values`` of D A D
  bit-identical to a fresh bind), ``dense`` on the 8,192-row
  ``unstruct_8k``; and ``pruned_linear`` with its defaults on the
  llama3_2_1b down projection.  The winner must have the least modeled
  bytes, its solve must converge and its kernel launch.  A tune store in a
  fresh directory (``tuning.set_store``) is active from here through 2d,
  so the cold plans save their decisions;
* the warm start (2c): the default plan and the ``mode="measure"`` plans
  at k = 1 and k = 16 planned again from that store on a fresh
  ``PlanCache`` (as a new process has), which must be three store hits
  with zero partitioning passes and zero tuner measurements, the cold
  plans' ``identity()``, bit-identical partitions and the tuned
  ``rhs_chunk``; then the warm default plan's bind, ``op @ x`` and solve
  (the cold plan's iterations) and the warm k = 16 plan's ``op @ X``
  (#2, #3, #8);
* the distributed path (11e): a one-rank NCCL group (an in-memory store)
  and ``init_device_mesh("cuda", (1,), mesh_dim_names=("data",))``;
  ``plan(m, mesh=)`` on the solve plan's partition and host build, then
  ``op @ x``, ``op @ X`` (K = 16), ``op.solve(b, precond="spai")`` with its
  dots all-reduced over the group and ``update_values`` of ``D A D`` —
  only #4, #9 and #6 may launch — against the local plan, scipy, a fresh
  sharded bind and the local solve, ``bind(validate="full")`` and
  ``verify_plan`` clean; then every rank's shard of ``elasticity3d(64)`` at
  4 ranks and of ``powerlaw_8k`` at 8 (which must push partial sums) in
  one process with the exchange replayed by indexing, against scipy and
  the shards' plain stages, with the halo words against the all-gather's;
  and the sharded apply and warm solve timed beside #2, #8 and the local
  fused solve;
* the serving path (11f): llama3_2_1b at full width (16 layers, d 2048,
  vocab 128,256 padded to 129,024), fp32 weights from a seeded generator
  and bf16 compute, through two ``ServeEngine``s whose LM head is the
  tied embedding pruned to density 0.1 and bound as ``ehyb_packed`` on
  bfs partitions: 12 requests (prompts of 4–64 tokens, 8 new tokens)
  through 4 slots, whose head launches #8 only, and two through 1 slot,
  whose head launches #2 only, every step's logits within 1e-4 of an
  fp32 product with the pruned dense head; then a timed run (prefill and
  decode ms a step, tokens a second), ``refresh_sparse_head`` with zero
  structure passes, ``chaos(fail_sparse_apply=True)`` degrading to the
  dense head and ``restore_sparse_head``, and #8 and #2 on the heads'
  containers against their plain versions, their bounds, the dense head
  in fp32 and bf16 and a torch CSR product;
* the train path (11g): llama3_2_1b at full width and depth (fp32 master
  weights, bf16 compute, fp32 AdamW moments, 2 microbatches, remat)
  through ``launch.train.build_trainer`` and ``ResilientTrainer.run`` for
  4 steps of 4 × 512 tokens — step ms, tokens a second, peak memory (the
  final save is called, not written: the 14.8 GB disk round trip is cut
  to the 2-layer run's), then 6 steps overfitting one batch, with no hand-written kernel launched; at 2
  layers, a resumed run against a straight one (1e-3) and a run that
  survives an injected failure; fixed-mask value training of the pruned
  FFN down projection (density 0.2, ``ehyb_packed``, 64 tokens), whose
  forwards launch #8, gradient against float64; and moonshot, grok,
  rwkv6 and jamba at their smoke configs against the port's CPU run;
* the mesh path (11h), in its own one-rank NCCL group: llama3_2_1b at
  full width and depth through ``build_trainer(..., mesh=make_host_mesh(1,
  1, "cuda"))`` (the state ``DTensor``s, each unit's parameters gathered
  inside its remat boundary, the step under its tensor-parallel context
  — `model` of one rank splits nothing, and the one-rank collectives are
  skipped —, each gradient reduced to its
  leaf's spec) for 3 steps against the unsharded trainer's (losses 1e-6, the first
  step's gradients and weights as ``step_vs_cpu`` holds them), one MoE
  layer at moonshot_v1_16b_a3b's full width through the distributed path
  (the expert all-to-all) against the local one, grok's ffn mode at smoke
  size, a 2-layer state restored onto the mesh bit for bit, and the dry
  run's argument half over every cell (how many fit the card);
* the dry run's cost half (11i): the same one-rank step costed by
  ``roofline.op_cost`` on a fake 1 × 1 CPU mesh in a subprocess, its
  predicted peak and flops held to the card's own step (10 %, 1 %), and
  llama3_2_1b and moonshot ``train_4k`` costed on the production meshes
  (rank 0 of a fake group of 256 and 512 ranks): flops a device, useful
  ratio, dominant roofline term, peak and fit, with no FAIL; and the
  headroom the dry run's ``fits`` keeps (the CUDA context and the
  allocator's reserve over the allocated bytes at that step's peak),
  logged beside ``dryrun.HEADROOM_BYTES``;
* the mesh prefill and decode (11j), in its own one-rank NCCL group:
  llama3_2_1b at full width, a prefill of 4 × 512 tokens and 16 decode
  steps through ``prefill(..., mesh=)``, ``decode_step(..., mesh=)`` and
  ``serve_logits`` against the unsharded path on the same weights (logits
  1e-4, the caches, prefill and decode ms), and the same decode step
  costed by ``roofline.op_cost`` on a fake one-rank CPU mesh against the
  card's own (peak 10 %, flops 1 %);
* the recurrent families on the mesh (11k), in its own one-rank NCCL
  group: rwkv6_7b at full width, 16 of its 32 layers (a prefill of 4 × 512 tokens
  and 16 decode steps) and one Mamba block at jamba_1_5_large_398b's full
  width (4 decode steps), each through the mesh prefill and decode
  against the unsharded path on the same weights (logits 1e-4, the RWKV
  and Mamba states, prefill and decode ms, in turns), and rwkv6_7b's
  decode step costed on a fake one-rank CPU mesh against the card's own
  (peak 10 %, flops 1 %);
* sequence-parallel activations (11l), in its own one-rank NCCL group:
  chameleon_34b at full width, cut to 1 layer, under its
  ``act_sharding="sp"`` and under ``"dp"``: the mesh prefill's logits
  and one mesh train step's loss, gradients and weights bit for bit
  (one rank splits nothing), and the step costed on a fake one-rank CPU
  mesh against the card's own (flops exact, peak 10 %);
* the transform-safe operator (11m), with no new build: on the solve's
  k = 1 plan, the value and x gradients through ``p.bind(v)``, the
  double backward and ``torch.func.vmap`` over 16 right-hand sides (#8
  once a call); in its own one-rank NCCL group, the sharded plan on the
  same partition and build: a tensor bind's three value tables against
  the host bind's bit for bit (fp32, bf16) with no host work, and the
  gradients in both spaces and the double backward — each against a
  float64 oracle on the card; the sharded tensor bind, one sharded
  backward and ``vmap(16)`` timed beside the paths they replace.

Beside them: a calibration fitted on the card (2d, ``tuning.calibrate()``
on ``DEFAULT_SUITE``, persisted into the store: measured ms and modeled
bytes per (matrix, format), each term's effective GB/s, each format's
intercept, the fit's agreement numbers) and ``elasticity3d(40)`` planned
under it with the store off (``elasticity3d(64)``, whose dense form the
card cannot hold, autotuned under a model that makes ``dense`` free);
and the full verifier (5d):
``bind(validate="full")`` on the k = 1, k = 16 and default plans, seeded
corruptions of the k = 1 container named by their rules, and a corrupt
structure refused by ``bind(validate="full")`` before any launch.

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

    python3 chip_smoke.py --mesh-step-ab OTHER_SRC [ROUNDS]

times 11h's steps alone (llama3_2_1b, 4 × 512 tokens, 2 microbatches:
six steps unsharded, then six on the one-rank mesh) in four processes a
round (default one round): ``OTHER_SRC``'s ``repro_torch`` (an unpacked
``git archive`` of another commit), this checkout's, this checkout's,
``OTHER_SRC``'s again, and
logs each one's step ms (the first step of each run is a warm-up) beside
the card's name and power limit: whether a change of the mesh step's time
between two runs comes from the code or from the run.

    python3 chip_smoke.py --serve-decode-ab OTHER_SRC [ROUNDS]

does the same for 11f's serving: its 4-slot engine serves its 12 requests
once, then three times timed (each prefill and decode step), and the
unsharded trunk's ``decode_step`` runs 40 times alone (4 rows at the
engine's 512-deep cache, no head); it logs each process's medians.
"""

import collections
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NX = 64                        # elasticity3d(64): 786,432 rows, 61.7M nnz
# the default plan, the warm start and the calibrated plan (2b-2d) run on
# elasticity3d(40): 192,000 rows.  At 786k rows the default-plan phase took
# ~300 s, most of it ranking partition strategies; every check is kept
NX_DEFAULT = 40
SEED = 0
K_RHS = 16                     # load cases applied to one stiffness matrix
D_MODEL, D_FF = 2048, 8192     # llama3_2_1b (src/repro/configs/llama3_2_1b.py)
TOKENS = 16
WARM_REPS = 5                  # warm fused solves timed (median kept)
SERVE_SLOTS = (4, 1)           # the serve phase's two engines
SERVE_REQUESTS = 12            # through the 4-slot engine
SERVE_NEW = 8                  # new tokens a request
SERVE_KW = dict(max_prompt=64, max_len=512, sparse_head_density=0.1,
                sparse_head_format="ehyb_packed",
                sparse_head_partition="bfs")
SUITE_K = (4, 32)              # rhs widths of the SUITE sweep
TRAIN_BATCH, TRAIN_SEQ = 4, 512  # the train phase: 2,048 tokens a step
TRAIN_STEPS = 4
VALUE_TOKENS = 64              # fixed-mask value training on #8
VALUE_DENSITY = 0.2
VALUE_STEPS = 5
VALUE_LR = 1e-3
NEW_ARCHS = ("moonshot_v1_16b_a3b", "grok_1_314b", "rwkv6_7b",
             "jamba_1_5_large_398b")
BANDWIDTH = 3.35e12            # H100 SXM data sheet, bytes/s
FP32_PEAK = 67e12              # H100 SXM fp32 outside the tensor cores
BF16_PEAK = 989e12             # H100 SXM bf16 tensor cores, dense
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


def top_device_us(dev_us: dict, n: int) -> dict:
    """The ``n`` largest device times (µs) by kernel name cut to 60
    characters; names that share the cut (instances of one template
    kernel) are summed, not overwritten."""
    cut = collections.Counter()
    for k, v in dev_us.items():
        cut[k[:60]] += v
    return {k: round(v, 1) for k, v in cut.most_common(n)}


# device kernels by the first category whose substring their name holds
DEVICE_CATEGORIES = (("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
                     ("copy", ("memcpy", "memset")),
                     ("reduce", ("reduce",)),
                     ("index", ("index", "scatter", "gather")),
                     ("elementwise", ("elementwise",)))


def device_ms_by_category(dev_us: dict) -> dict:
    out = dict.fromkeys([c for c, _ in DEVICE_CATEGORIES] + ["other"], 0.0)
    for k, v in dev_us.items():
        low = k.lower()
        out[next((c for c, keys in DEVICE_CATEGORIES
                  if any(sub in low for sub in keys)), "other")] += v / 1e3
    return {k: round(v, 3) for k, v in out.items()}


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
                       healthy) -> dict:
    """The sixth main path (see the module docstring) on ``m``: the default
    plan, the measured pass, the four plain formats pinned at full size
    (each verified, ``analysis.verify``), ``dense`` on ``unstruct_8k`` and
    the pruned layer with its defaults.  Every plan it makes joins
    ``plans``; raises on a failed check.  Returns the three cold plans the
    store phase plans again, ``{name: (execution, plan, seconds)}``, and
    the default plan's solve iterations under ``"iters"``."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.analysis import verify
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
    # the byte model's partition against a pinned bfs plan of the same
    # format, the same applies on the card
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
    cold = {"default": (ExecutionConfig(), p, t_plan), "iters": int(res.iters)}
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
    cold["measure-k1"] = (ExecutionConfig(mode="measure"), pm, t_m)
    cold["measure-k16"] = (ExecutionConfig(mode="measure", k=K_RHS), pk, t_k)
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
        t0 = time.perf_counter()
        findings = verify(of2)
        t_v = time.perf_counter() - t0
        log("pinned-format", format=fmt, n=mf.n, bind_s=round(t_b, 3),
            rebind_s=round(t_r, 3), vs_scipy_f64_k1=e1,
            vs_scipy_f64_k16=e16, apply_ms=ms1, rebind_bit_identical=same,
            shared_structure=shared, verify_s=round(t_v, 3),
            findings=len(findings))
        check(e1 <= 1e-4 and e16 <= SPMM_TOL["float32"],
              f"{fmt}: op @ x {e1}, op @ X {e16} vs scipy")
        check(same and shared, f"{fmt}: the rebind equals a fresh bind and "
              f"shares the structure")
        check(findings == [], f"{fmt}: verify found {findings[:3]}")
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
    return cold


def store_phase(dev, m, cold: dict, plans: list, all_kernels: dict,
                healthy):
    """The seventh main path: the three cold plans of phase 2b planned
    again from the tune store they saved into — on a fresh ``PlanCache``
    (empty partition, partition-decision and host-build memos, as in a new
    process; the script's ``PLAN_CACHE`` stays for the later phases) with
    the tuner memo cleared — then ``op @ x`` and the CG + SPAI solve on
    the warm default plan and ``op @ X`` on the warm k = 16 plan with its
    stored ``rhs_chunk``, counts from 0.  Returns the warm default plan."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.api import PlanCache, plan
    from repro_torch.autotune import tuner
    from repro_torch.autotune.registry import get_format
    from repro_torch.core import counters

    t_phase = time.perf_counter()
    cache = PlanCache()
    tuner.clear_cache()
    warm = {}
    c0 = counters.snapshot()
    for name in ("default", "measure-k1", "measure-k16"):
        ex, cp, t_cold = cold[name]
        t0 = time.perf_counter()
        wp = plan(m, execution=ex, device=dev, cache=cache)
        t_warm = time.perf_counter() - t0
        warm[name] = wp
        same_part = all(np.array_equal(getattr(wp.partition, f),
                                       getattr(cp.partition, f))
                        for f in ("part_vec", "perm", "inv_perm"))
        log("store-warm-plan", plan=name, cold_s=round(t_cold, 3),
            warm_s=round(t_warm, 3), format=wp.format,
            strategy=wp.partition_strategy, tuned=wp.tuned.to_dict(),
            identity_equal=wp.identity() == cp.identity(),
            partition_bit_identical=same_part)
        check(wp.identity() == cp.identity() and same_part
              and (wp.n_parts, wp.vec_size) == (cp.n_parts, cp.vec_size),
              f"{name}: the warm plan equals the cold one")
        check(wp.tuning is None and wp.partition_tuning is None,
              f"{name}: served by the store, not tuned")
    c1 = counters.snapshot()
    delta = {k: c1.get(k, 0) - c0.get(k, 0)
             for k in ("tune_store.hit", "tune_store.miss", "partition",
                       "tune.measured", "build_ehyb")}
    log("store-warm-counters", **delta)
    check(delta["tune_store.hit"] == 3 and delta["tune_store.miss"] == 0
          and delta["partition"] == 0 and delta["tune.measured"] == 0
          and delta["build_ehyb"] == 0,
          f"the warm plans were served by the store alone: {delta}")
    wd, wk = warm["default"], warm["measure-k16"]
    check(wk.tuned.rhs_chunk == cold["measure-k16"][1].tuned.rhs_chunk,
          "the k = 16 plan keeps its tuned rhs_chunk")

    # -- counts from 0, then the warm default plan's bind, op @ x and
    #    solve, and the warm k = 16 plan's op @ X -----------------------------
    a_sp = sp.csr_matrix((m.data, m.indices, m.indptr), shape=(m.n, m.n))
    rng = np.random.default_rng(SEED + 5)
    x_host, b_host = rng.standard_normal(m.n), rng.standard_normal(m.n)
    X_host = rng.standard_normal((m.n, K_RHS))
    x = torch.as_tensor(x_host, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b_host, dtype=torch.float32, device=dev)
    X = torch.as_tensor(X_host, dtype=torch.float32, device=dev)
    for fn in all_kernels.values():
        fn.launches = 0
    b0 = counters.snapshot()
    t0 = time.perf_counter()
    op = wd.bind(m)
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t0
    y = op @ x
    res = op.solve(b, precond="spai", tol=1e-6)
    t0 = time.perf_counter()
    op16 = wk.bind(m)
    torch.cuda.synchronize()
    t_bind16 = time.perf_counter() - t0
    Y = op16 @ X
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in all_kernels.items() if f.launches}
    b1 = counters.snapshot()
    err = rel_err(y.cpu(), a_sp @ x_host)
    err16 = rel_err(Y.cpu(), a_sp @ X_host)
    b32 = b_host.astype(np.float32).astype(np.float64)
    true_res = float(np.linalg.norm(b32 - a_sp @ res.x.double().cpu().numpy())
                     / np.linalg.norm(b32))
    log("store-warm-path", bind_s=round(t_bind, 3),
        bind_k16_s=round(t_bind16, 3), vs_scipy_f64=err,
        vs_scipy_f64_k16=err16, status=res.status, iters=int(res.iters),
        cold_iters=cold["iters"], true_residual=true_res,
        rhs_chunk=getattr(op16.obj, "rhs_chunk", None), launches=launches,
        partition=b1.get("partition", 0) - b0.get("partition", 0))
    check(err <= 1e-4 and err16 <= SPMM_TOL["float32"],
          f"warm plans vs scipy: {err}, {err16}")
    check(res.status == "converged" and true_res <= 1e-5
          and int(res.iters) == cold["iters"],
          f"warm solve: {res.status}, {int(res.iters)} iterations against "
          f"the cold plan's {cold['iters']}")
    check(b1.get("partition", 0) == b0.get("partition", 0),
          "the warm binds built on the stored partitions")
    check(launches.get("fused_cg_update", 0) > 0,
          "the warm solve went through the CG-step kernel (#3)")
    if get_format(wd.format).kernel == "cuda":
        check(launches.get("ehyb_packed_fused", 0) > 0,
              "op @ x and the solve went through #2")
    if wk.format == "ehyb_packed":
        check(op16.obj.rhs_chunk == wk.tuned.rhs_chunk
              and launches.get("ehyb_packed_fused_spmm", 0) > 0,
              "op @ X went through #8 with the stored rhs_chunk")
    plans += [wd, warm["measure-k1"], wk]
    del op, op16, y, Y, res, cache
    healthy("store-warm")
    torch.cuda.empty_cache()
    log("store-phase", seconds=round(time.perf_counter() - t_phase, 3))
    return wd


def calibration_phase(dev, m, m_big, plans: list, healthy) -> None:
    """``tuning.calibrate()`` on ``DEFAULT_SUITE`` on the card, persisted
    into the active store; then ``m`` planned with every default (the
    dtype spelled out, so the cache answers with a new plan that shares
    phase 2b's partition decisions and host build) under the fitted model
    with the store switched off — a store hit would replace the tuner, and
    the calibration would decide nothing; then ``m_big`` (the solve's
    matrix, whose dense form the card cannot hold) autotuned on
    ``plans[0]``'s host build under a model that makes ``dense`` free."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch import tuning
    from repro_torch.api import ExecutionConfig, plan
    from repro_torch.autotune import TERMS, autotune, available_formats
    from repro_torch.tuning.calibration import CalibrationModel

    t_phase = time.perf_counter()
    store = tuning.get_store()
    out = tuning.calibrate(device=dev)
    t_cal = time.perf_counter() - t_phase
    for s in out["samples"]:
        log("calibration-sample", matrix=s["matrix"], format=s["format"],
            measured_ms=s["measured_s"] * 1e3,
            modeled_bytes=s["modeled_bytes"])
    model = out["model"]
    ev = out["evaluation"]
    log("calibration-terms", **{
        f"{t}_GBps": (1.0 / c / 1e9 if c > 0 else "inf")
        for t, c in model["coef"].items()})
    log("calibration-intercepts",
        **{f"{f}_us": b * 1e6 for f, b in model["intercept"].items()})
    log("calibration", backend=model["backend"], seconds=round(t_cal, 3),
        n_samples=model["n_samples"], r2=model["stats"]["r2"],
        ratio_geomean=ev["ratio_geomean"], ratio_min=ev["ratio_min"],
        ratio_max=ev["ratio_max"], contested=ev["contested"],
        agree_raw=ev["agree_raw"], agree_calibrated=ev["agree_calibrated"],
        persisted=out["persisted"])
    for row in ev["matrices"]:
        log("calibration-winners", matrix=row["matrix"],
            measured=row["measured_winner"], raw=row["raw_winner"],
            calibrated=row["calibrated_winner"])
    check(out["persisted"] and store.load_calibration(model["backend"])
          is not None, "the calibration is persisted in the store")
    check(model["backend"] == tuning.backend_key(dev)
          and "ehyb_packed" in {s["format"] for s in out["samples"]},
          "the calibration measured the card's kernel format")

    tuning.set_store(None)
    try:
        t0 = time.perf_counter()
        pc = plan(m, execution=ExecutionConfig(dtype=torch.float32),
                  device=dev)
        t_plan = time.perf_counter() - t0
        cal = pc.tuning.calibrated_s
        log("calibrated-plan", format=pc.format,
            strategy=pc.partition_strategy, plan_s=round(t_plan, 3),
            **{f"{f}_ms": s * 1e3 for f, s in sorted(
                cal.items(), key=lambda kv: kv[1])})
        check(cal is not None and pc.format == min(sorted(cal),
                                                   key=cal.get),
              "the calibrated plan picks the least predicted seconds")
        rng = np.random.default_rng(SEED + 6)
        x_host = rng.standard_normal(m.n)
        op = pc.bind(m)
        y = op @ torch.as_tensor(x_host, dtype=torch.float32, device=dev)
        a_sp = sp.csr_matrix((m.data, m.indices, m.indptr),
                             shape=(m.n, m.n))
        err = rel_err(y.cpu(), a_sp @ x_host)
        log("calibrated-plan-path", vs_scipy_f64=err)
        check(err <= 1e-4, f"calibrated plan op @ x vs scipy: {err}")
        plans.append(pc)
        del op, y
        # a fit can clamp the "ell" term to zero, which makes the dense
        # stream free: under such a model the tuner must still not choose
        # a format whose tables the card cannot hold (dense at n = m.n
        # would ask for n * n * 4 bytes)
        tuning.set_model(CalibrationModel(
            backend=model["backend"], coef={t: 0.0 for t in TERMS},
            intercept={f: float(f != "dense") for f in available_formats()}))
        p0 = plans[0]
        free = autotune(m_big, torch.float32,
                        shared={"ehyb": p0.host_build(m_big)},
                        context=pc.tuning.context, device=dev,
                        use_cache=False)
        log("calibrated-dense-free", format=free.format,
            dense_modeled_bytes=free.modeled_bytes["dense"],
            card_bytes=torch.cuda.get_device_properties(dev).total_memory,
            ranked=sorted(free.calibrated_s))
        check(free.format != "dense" and "dense" not in free.calibrated_s,
              "a format larger than the card is not a candidate")
    finally:
        tuning.set_store(store)
        tuning.set_model(None)
    healthy("calibration")
    torch.cuda.empty_cache()
    log("calibration-phase", seconds=round(time.perf_counter() - t_phase, 3))


def dist_phase(dev, m, smi: str, op, data: dict, plans: list,
               all_kernels: dict, healthy) -> dict:
    """The eighth main path (11e): the distributed path on a one-rank NCCL
    group (an in-memory store) and ``init_device_mesh("cuda", (1,),
    mesh_dim_names=("data",))``.  ``plan(m, mesh=)`` on the k = 1 plan's
    partition and host build, then, counts from 0: ``op @ x``, ``op @ X``
    (K = 16), ``op.solve(b, precond="spai")`` with its dots
    ``all_reduce``-d over the group and ``update_values`` of D A D with an
    apply — through #4, #9 and #6, against the local plan, scipy, a fresh
    sharded bind and the local solve.  Then every rank's shard of
    ``elasticity3d(64)`` at 4 ranks and of ``powerlaw_8k`` at 8 (which must
    push partial sums) applied in this process with the exchange replayed
    by indexing, against scipy and the same shards' plain stages; and the
    sharded apply and warm solve timed beside the local #2, #8 and fused
    solve.  ``data`` holds the main path's vectors: ``x``, ``x_host``,
    ``xb``, ``xb_host``, ``b``, ``b_host``, ``a_sp``, ``res``.  Returns the
    main path's launches of #4, #9 and #6."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis import verify_plan
    from repro_torch.api import ExecutionConfig, plan
    from repro_torch.core import counters
    from repro_torch.core.ehyb import build_ehyb
    from repro_torch.core.matrices import SUITE, SparseCSR
    from repro_torch.dist import build_halo_plan
    from repro_torch.dist.operator import (_build_sharded_operator,
                                           _ell_kernel, _shards_from_ehyb,
                                           local_apply_plain, replay_apply,
                                           shard_of, sharded_apply_permuted)
    from repro_torch.kernels import ehyb_spmv as K
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    x, x_host, xb, xb_host = (data[k] for k in ("x", "x_host", "xb",
                                                "xb_host"))
    b, b_host, a_sp, res = (data[k] for k in ("b", "b_host", "a_sp", "res"))
    path = ("ehyb_ell", "ehyb_ell_spmm", "er")
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        cfg = ExecutionConfig(format="ehyb_packed", partition_method="bfs")
        t0 = time.perf_counter()
        pd = plan(m, mesh=mesh, execution=cfg)
        t_plan = time.perf_counter() - t0
        t0 = time.perf_counter()
        opd = pd.bind(m)
        torch.cuda.synchronize()
        t_bind = time.perf_counter() - t0
        plans.append(pd)
        e = op.plan.host_build(m)
        check(pd.is_sharded and pd.context == "solver"
              and pd.partition is op.plan.partition
              and pd.host_build(m) is e,
              "the mesh plan shares the k = 1 plan's partition and build")
        hp = opd.halo_plan
        check(hp.n_dev == 1 and hp.halo_words == 0 and not hp.needs_comm,
              "a one-rank plan exchanges nothing")
        dvec = 1.0 + 0.25 * np.random.default_rng(SEED + 1).random(m.n)
        row_of_m = np.repeat(np.arange(m.n), m.row_lengths())
        m2 = SparseCSR(m.n, m.indptr, m.indices,
                       m.data * dvec[row_of_m] * dvec[m.indices])
        # -- the main path: counts from 0 ------------------------------------
        torch.cuda.synchronize()
        before = counters.snapshot()
        for fn in all_kernels.values():
            fn.launches = 0
        yd = opd @ x
        yd16 = opd @ xb
        t0 = time.perf_counter()
        rd = opd.solve(b, precond="spai", tol=1e-6)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        t0 = time.perf_counter()
        opd2 = opd.update_values(m2)
        torch.cuda.synchronize()
        t_refill = time.perf_counter() - t0
        yd2 = opd2 @ x
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in all_kernels.items()}
        after = counters.snapshot()
        work = {c: after.get(c, 0) - before.get(c, 0)
                for c in ("partition", "build_ehyb", "build_halo_plan",
                          "group_er", "pack_staircase", "kernels.nvcc")}
        log("dist-main-path", launches=launches, structure_work=work,
            plan_s=round(t_plan, 3), bind_s=round(t_bind, 3),
            refill_s=round(t_refill, 3), first_solve_s=round(t_solve, 4))
        check(all(launches[k] == 0 for k in launches if k not in path),
              "the sharded path launches only #4, #9 and #6")
        check(launches["ehyb_ell"] >= int(rd.iters) + 2
              and launches["ehyb_ell_spmm"] >= 1
              and launches["er"] >= int(rd.iters) + 3,
              f"the sharded path went through #4, #9 and #6: {launches}")
        check(all(v == 0 for v in work.values()),
              f"the sharded refill runs no structure pass: {work}")
        # -- against the local plan, scipy, the local solve, a fresh bind ----
        y_sp = a_sp @ x_host
        y16_sp = a_sp @ xb_host
        errs = {"k1_vs_local": rel_err(yd.cpu(), (op @ x).cpu()),
                "k1_vs_scipy_f64": rel_err(yd.cpu(), y_sp),
                "k16_vs_local": rel_err(yd16.cpu(), (op @ xb).cpu()),
                "k16_vs_scipy_f64": rel_err(yd16.cpu(), y16_sp)}
        x_sol = rd.x.double().cpu().numpy()
        b32 = b_host.astype(np.float32).astype(np.float64)
        true_res = float(np.linalg.norm(b32 - a_sp @ x_sol)
                         / np.linalg.norm(b32))
        t0 = time.perf_counter()
        e_fresh = build_ehyb(m2, part=pd.partition)
        fresh = _build_sharded_operator(e_fresh, mesh, "data",
                                        dtype=torch.float32)
        t_fresh = time.perf_counter() - t0
        errs["refill_vs_fresh"] = rel_err(yd2.cpu(), fresh(x).cpu())
        shared = all(getattr(opd2.obj, f) is getattr(opd.obj, f)
                     for f in ("ell_cols", "col_rows", "fer_cols",
                               "fer_col_rows", "fer_rows", "perm"))
        del fresh, e_fresh
        t0 = time.perf_counter()
        pd.bind(m, validate="full")
        t_full = time.perf_counter() - t0
        plan_findings = verify_plan(pd)
        log("dist-checks", **errs, solve_iters=int(rd.iters),
            solve_status=rd.status, true_residual_f64=true_res,
            local_iters=int(res.iters), structure_shared=shared,
            fresh_bind_s=round(t_fresh, 3), bind_full_s=round(t_full, 3),
            verify_plan=len(plan_findings))
        check(errs["k1_vs_local"] <= 1e-5 and errs["k16_vs_local"] <= 1e-5,
              f"the sharded apply equals the local plan's: {errs}")
        check(errs["k1_vs_scipy_f64"] <= 1e-4
              and errs["k16_vs_scipy_f64"] <= 1e-4, f"vs scipy: {errs}")
        check(rd.status == "converged" and true_res <= 1e-5
              and abs(int(rd.iters) - int(res.iters)) <= 1,
              "the sharded solve converged within one iteration of the "
              "local one")
        check(errs["refill_vs_fresh"] <= 1e-5 and shared,
              "the sharded refill equals a fresh sharded bind, structure "
              "shared")
        check(plan_findings == [], f"verify_plan: {plan_findings}")
        # -- every rank's shard in this process, the exchange replayed ------
        pm = SUITE["powerlaw_8k"]()
        pe = plan(pm, execution=ExecutionConfig(
            format="ehyb", partition_method="bfs"),
            device=dev).host_build(pm)
        pm_sp = sp.csr_matrix((pm.data, pm.indices, pm.indptr),
                              shape=(pm.n, pm.n))
        rng = np.random.default_rng(SEED + 2)
        px = rng.standard_normal((pm.n, K_RHS))
        for label, mat_sp, e_, nd, cases in (
                ("elasticity3d_64", a_sp, e, 4,
                 ((1, x_host, x), (K_RHS, xb_host, xb))),
                ("powerlaw_8k", pm_sp, pe, 8,
                 ((1, px[:, 0], None), (K_RHS, px, None)))):
            t0 = time.perf_counter()
            hp_n = build_halo_plan(e_, nd)
            shards = [_shards_from_ehyb(e_, hp_n, torch.float32, dev, r)[0]
                      for r in range(nd)]
            torch.cuda.synchronize()
            t_shard = time.perf_counter() - t0
            out = {}
            for k, xh, xt in cases:
                xt = xt if xt is not None else torch.as_tensor(
                    xh, dtype=torch.float32, device=dev)
                xs = [shard_of(o_, xt) for o_ in shards]
                y = torch.cat(replay_apply(shards, xs))
                y_again = torch.cat(replay_apply(shards, xs))
                y_plain = torch.cat(replay_apply(shards, xs, plain=True))
                y_orig = y[shards[0].inv_perm[: e_.n]].cpu()
                out[f"k{k}_vs_scipy_f64"] = rel_err(y_orig, mat_sp @ xh)
                out[f"k{k}_vs_plain"] = rel_to_largest(y.cpu(),
                                                       y_plain.cpu())
                out[f"k{k}_bit_identical"] = bool(torch.equal(y, y_again))
            log("dist-shards", matrix=label, n_dev=nd,
                halo_words=hp_n.halo_words,
                allgather_words=hp_n.allgather_words,
                halo_share=round(hp_n.halo_words / hp_n.allgather_words, 6),
                has_push=hp_n.has_push, needs_comm=hp_n.needs_comm,
                seg_len=hp_n.seg_len, halo_len=hp_n.halo_len,
                push_words=int(hp_n.counts_push.sum()),
                fetch_words=int(hp_n.counts_fetch.sum()),
                plan_and_shards_s=round(t_shard, 3), **out)
            check(all(v <= 1e-4 for kk, v in out.items()
                      if kk.endswith(("scipy_f64", "plain"))),
                  f"{label} at {nd} ranks: {out}")
            if label == "powerlaw_8k":
                check(hp_n.has_push, "powerlaw_8k at 8 ranks pushes")
            del shards
        # -- times: the sharded apply and solve beside the local kernels ----
        o = op.obj
        xl, xbl = opd.to_space(x), opd.to_space(xb)
        x_new, xb_new = op.to_space(x), op.to_space(xb)
        od = opd.obj
        t = {"sharded_k1": time_ms(lambda: sharded_apply_permuted(od, xl),
                                   dev),
             "sharded_k16": time_ms(lambda: sharded_apply_permuted(od, xbl),
                                    dev),
             "plain_k1": time_ms(lambda: local_apply_plain(
                 od, xl[:, None], None), dev),
             "ell_4_k1": time_ms(lambda: _ell_kernel(od, xl.reshape(
                 od.ell_vals.shape[0], od.vec_size, 1)), dev),
             "er_6_k1": time_ms(lambda: K.er(xl, od.fer_vals, od.fer_cols,
                                             od.fer_col_rows), dev),
             "local_2_k1": time_ms(lambda: ops.ehyb_spmv_packed_permuted(
                 o, x_new), dev),
             "local_8_k16": time_ms(lambda: ops.ehyb_spmv_packed_permuted(
                 o, xb_new), dev)}
        # one rank pushes nothing and adds each ER row once: the same bits
        # on every launch (the replays above, which push, are not)
        same_1 = bool(torch.equal(sharded_apply_permuted(od, xl),
                                  sharded_apply_permuted(od, xl)))
        check(same_1, "the one-rank sharded apply is bit-identical over two "
              "launches")
        warm = {"sharded": [], "local_fused": []}
        for label, o_ in (("sharded", opd), ("local_fused", op)):
            for _ in range(WARM_REPS):
                t0 = time.perf_counter()
                r_ = o_.solve(b, precond="spai", tol=1e-6)
                torch.cuda.synchronize()
                warm[label].append(time.perf_counter() - t0)
        log("dist-times", card=repr(smi), **{k: v for k, v in t.items()},
            sharded_vs_local_k1=round(t["sharded_k1"] / t["local_2_k1"], 4),
            sharded_vs_local_k16=round(
                t["sharded_k16"] / t["local_8_k16"], 4),
            warm_solve_sharded_s=statistics.median(warm["sharded"]),
            warm_solve_local_fused_s=statistics.median(warm["local_fused"]),
            warm_reps=WARM_REPS, bit_identical_one_rank=same_1)
        healthy("dist")
        del opd, opd2, yd, yd16, yd2, pd
    finally:
        dist.destroy_process_group()
    log("dist-phase", seconds=round(time.perf_counter() - t_phase, 3))
    return {k: launches[k] for k in path}


def verify_phase(m, main_plans: dict, op, all_kernels: dict) -> None:
    """``bind(validate="full")`` on the main plans, ``{name: (plan,
    matrix)}`` (each also holds its tables to its host build's pattern);
    seeded corruptions of clones of
    the k = 1 container, named by their rules; the plan's structure
    corrupted the first way (what every rebind scatters into) refused by
    ``bind(validate="full")`` before any launch."""
    import torch

    from repro_torch.analysis import verify

    t_phase = time.perf_counter()
    for name, (p, mp) in main_plans.items():
        t0 = time.perf_counter()
        opv = p.bind(mp, validate="full")
        torch.cuda.synchronize()
        log("verify-full", plan=name, format=p.format,
            seconds=round(time.perf_counter() - t0, 3))
        del opv
    o = op.obj
    bad = {}
    for field, idx, value, rule in (
            ("packed_cols", (0, 0), o.vec_size, "index-bound.ell-local"),
            ("er_s_cols", 0, o.n_pad, "index-bound.er-global")):
        t = getattr(o, field).clone()
        t[idx] = value
        bad[field] = t
        t0 = time.perf_counter()
        rules = sorted({f.rule for f in verify(
            dataclasses.replace(o, **{field: t}))})
        log("verify-seeded", field=field, value=value, rules=rules,
            seconds=round(time.perf_counter() - t0, 3))
        check(rule in rules, f"{field} = {value} named {rules}, not {rule}")
    bad_plan = dataclasses.replace(
        op.plan, _structure=dataclasses.replace(
            op.plan._structure, packed_cols=bad["packed_cols"]),
        _last={}, _guards={})
    before = {k: f.launches for k, f in all_kernels.items()}
    t0 = time.perf_counter()
    try:
        bad_plan.bind(m, validate="full")
        raised = ""
    except ValueError as e:
        raised = str(e)
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in all_kernels.items()}
    log("verify-refused", field="packed_cols",
        raised="index-bound.ell-local" in raised,
        launches_moved=after != before,
        seconds=round(time.perf_counter() - t0, 3))
    check("index-bound.ell-local" in raised and after == before,
          "bind(validate='full') refuses the corrupt structure before any "
          "launch")
    del bad, bad_plan
    torch.cuda.empty_cache()
    log("verify-phase", seconds=round(time.perf_counter() - t_phase, 3))

@contextlib.contextmanager
def head_stage_seconds(seconds: dict):
    """Host-clock seconds of ``pruned_linear``'s three stages (prune, plan,
    first bind) while an engine builds its sparse head: the stages are
    wrapped for the duration of the block, and each synchronises the card
    before its clock stops."""
    import torch

    nn = importlib.import_module("repro_torch.api.nn")
    real_prune, real_plan, bound = nn.prune_to_csr, nn._plan, []

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            return out
        return run

    def plan(*a, **kw):
        p = timed("plan", real_plan)(*a, **kw)
        p.bind = timed("bind", p.bind)
        bound.append(p)
        return p

    nn.prune_to_csr, nn._plan = timed("prune", real_prune), plan
    try:
        yield seconds
    finally:
        nn.prune_to_csr, nn._plan = real_prune, real_plan
        for p in bound:
            del p.bind


def serve_phase(dev, smi: str, plans: list, all_kernels: dict,
                healthy) -> dict:
    """The serving main path (phase 11f): llama3_2_1b at full width (16
    layers, d 2048, 32 heads with 8 KV heads, d_ff 8192, vocab 128,256
    padded to 129,024), fp32 weights from a seeded generator, bf16
    compute, served by two ``ServeEngine``s whose LM head is the tied
    embedding pruned to density 0.1 and bound as ``ehyb_packed`` on bfs
    partitions (the format and strategy pinned: no partition ranking).

    With every count at 0, 12 requests (seeded prompts of 4–64 tokens, 8
    new tokens) run through the 4-slot engine, whose head applies launch
    #8 only (K = 4 every step), and two through the 1-slot one, whose head
    launches #2 only; every sparse-head step's logits are held against an
    fp32 ``torch.matmul`` of the same hidden states with the pruned dense
    head.  Then: a timed run of the same requests (prefill and decode ms a
    step, tokens a second); ``refresh_sparse_head`` of doubled weights
    with zero structure passes and the next step's logits against the
    doubled head; ``chaos(fail_sparse_apply=True)`` degrading to the dense
    head with every admitted request finished, and
    ``restore_sparse_head``; #8 and #2 against their plain versions on the
    heads' own containers, and timed beside their bounds, the dense head
    (fp32, bf16) and a torch CSR product of the pruned head.  Returns the
    main path's launches {kernel: n}."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import counters
    from repro_torch.kernels import ehyb_spmm as KM
    from repro_torch.kernels import ehyb_spmv as K
    from repro_torch.kernels import ref
    from repro_torch.models import init_model
    from repro_torch.models.layers import pad_vocab
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.reliability import ReliabilityWarning, chaos
    from repro_torch.serve import Request, ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config("llama3_2_1b")
    v_pad = pad_vocab(cfg.vocab_size)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, v_pad, cfg.dtype, cfg.param_dtype)
          == (16, 2048, 32, 8, 8192, 128256, 129024, "bfloat16",
              "float32"), "llama3_2_1b at full width")
    t0 = time.perf_counter()
    params = init_model(torch.Generator(dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))

    engines, setup = {}, {}
    for slots in SERVE_SLOTS:
        t0 = time.perf_counter()
        with head_stage_seconds({}) as stage_s:
            eng = ServeEngine(params, cfg, batch=slots, device=dev,
                              **SERVE_KW)
        torch.cuda.synchronize()
        head = eng.sparse_head
        setup[slots] = {"engine_s": round(time.perf_counter() - t0, 3),
                        **{f"{k}_s": round(v, 3)
                           for k, v in stage_s.items()},
                        "n_parts": head.op.plan.n_parts,
                        "vec_size": head.op.plan.vec_size}
        check(head.op.format == "ehyb_packed"
              and head.op.plan.partition_strategy == "bfs",
              "the head is ehyb_packed on bfs partitions")
        engines[slots] = eng
        plans.append(head.op.plan)
    head4, head1 = engines[4].sparse_head, engines[1].sparse_head
    csr = head4.csr
    check(csr.nnz == head1.csr.nnz and csr.n == v_pad
          and (head4.d_out, head4.d_in) == (v_pad, cfg.d_model),
          "both engines pruned the same (V, d) head")
    rows = np.repeat(np.arange(csr.n), csr.row_lengths())
    w_sp = sp.csr_matrix((csr.data, (rows, csr.indices)),
                         shape=(head4.d_out, head4.d_in))
    w_dense = torch.as_tensor(w_sp.toarray(), dtype=torch.float32,
                              device=dev)
    e4 = head4.ehyb
    nnz_er = int(csr.nnz - e4.nnz_in)
    log("serve-setup", model=cfg.name, params=n_params,
        init_s=round(t_init, 3), head_nnz=csr.nnz,
        head_density=SERVE_KW["sparse_head_density"],
        er_share=round(nnz_er / csr.nnz, 4),
        **{f"slots{s}": v for s, v in setup.items()})

    # the fp32 dense product of the same hidden states with the pruned
    # head (scaled with the refresh below), every sparse-head step
    w_now = [w_dense]
    head_errs, last_h = [], {}

    def watch(eng, slots) -> None:
        real = ServeEngine._head_logits.__get__(eng)

        def spy(h, head, head_obj=None):
            out = real(h, head, head_obj)
            if head is not None:
                want = torch.matmul(h[:, 0].float(), w_now[0].T)
                head_errs.append(float((out[:, 0] - want).abs().max()
                                       / want.abs().max()))
                last_h[slots] = h
            return out

        eng._head_logits = spy

    rng = np.random.default_rng(SEED)
    lens = rng.integers(4, SERVE_KW["max_prompt"] + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in lens]

    def serve(eng, idx, uid0=0, new=SERVE_NEW):
        for j, i in enumerate(idx):
            eng.submit(Request(uid=uid0 + j, prompt=prompts[i],
                               max_new_tokens=new))
        return eng.run_until_done()

    def resolve(eng, slots) -> None:
        op = eng.sparse_head.op          # the guard probes once (#2)
        op @ torch.zeros((op.n, slots), device=dev)
        torch.cuda.synchronize()

    # -- main path: counts from 0, 12 requests through the 4-slot engine,
    #    then two through the 1-slot engine ---------------------------------
    launches = {}
    for slots, idx in ((4, range(SERVE_REQUESTS)), (1, range(2))):
        eng = engines[slots]
        resolve(eng, slots)
        watch(eng, slots)
        n_err = len(head_errs)
        for fn in all_kernels.values():
            fn.launches = 0
        done = serve(eng, idx)
        torch.cuda.synchronize()
        launches[slots] = {k: f.launches for k, f in all_kernels.items()}
        applies = len(head_errs) - n_err
        want = "ehyb_packed_fused_spmm" if slots > 1 else "ehyb_packed_fused"
        log("serve-main-path", slots=slots, requests=len(done),
            tokens=sum(len(r.generated) for r in done),
            head_applies=applies,
            launches={k: v for k, v in launches[slots].items() if v},
            head_vs_f32_dense=max(head_errs[n_err:]))
        check(len(done) == len(idx) and all(
            len(r.generated) == SERVE_NEW for r in done),
            f"{slots} slots: every request finished with its tokens")
        check(launches[slots][want] == applies and all(
            v == 0 for k, v in launches[slots].items() if k != want),
            f"{slots} slots: every head apply launched {want} once, and "
            f"nothing else hand-written launched: {launches[slots]}")
        check(max(head_errs[n_err:]) <= 1e-4,
              f"{slots} slots: the head's logits within 1e-4 of the fp32 "
              f"dense product")
        check(not eng.degraded, "the engine serves its sparse head")
    healthy("serve-main-path")

    # -- the timed run: the same 12 requests, no logit check ---------------
    eng4 = engines[4]
    del eng4._head_logits
    step_s = {"prefill": [], "decode": []}
    real_call = eng4._guarded_call

    def timed(which, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_call(which, *args)
        torch.cuda.synchronize()
        step_s[which].append(time.perf_counter() - t)
        return out

    eng4._guarded_call = timed
    t0 = time.perf_counter()
    done = serve(eng4, range(SERVE_REQUESTS), uid0=100)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    del eng4._guarded_call
    # where a step's time goes: a profiler trace of one prefill and four
    # decode steps (4 requests, 5 tokens each); device busy time (the
    # device's own activities) against the same steps' unprofiled time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(eng4, range(4), uid0=150, new=5)
        torch.cuda.synchronize()
        t_traced = time.perf_counter() - t0
    dev_us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and ev.self_device_time_total > 0
              and not ev.key.startswith("Activity Buffer")}
    busy_ms = sum(dev_us.values()) / 1e3
    wall_ms = 1e3 * (statistics.median(step_s["prefill"])
                     + 4 * statistics.median(step_s["decode"]))
    log("serve-trace", steps="1 prefill + 4 decode", unprofiled_ms=wall_ms,
        traced_wall_ms=t_traced * 1e3, device_busy_ms=busy_ms,
        idle_share=(1 - busy_ms / wall_ms) if busy_ms else "not measured",
        device_activities=sum(ev.count for ev in prof.key_averages()
                              if ev.key in dev_us),
        top_device_us=top_device_us(dev_us, 8))
    n_tok = sum(len(r.generated) for r in done)
    log("serve-times", card=repr(smi), slots=4, requests=len(done),
        tokens=n_tok,
        seconds=round(t_run, 4), tokens_per_s=round(n_tok / t_run, 2),
        prefill_steps=len(step_s["prefill"]),
        prefill_ms=round(1e3 * statistics.median(step_s["prefill"]), 3),
        decode_steps=len(step_s["decode"]),
        decode_ms=round(1e3 * statistics.median(step_s["decode"]), 3),
        decode_ms_min=round(1e3 * min(step_s["decode"]), 3),
        decode_ms_max=round(1e3 * max(step_s["decode"]), 3))

    # -- the refresh: doubled weights, zero structure passes, and the next
    #    step's logits follow them ------------------------------------------
    obj0 = head4.op.obj
    params2 = dict(params, embed=dict(
        params["embed"], embedding=params["embed"]["embedding"] * 2.0))
    before = counters.snapshot()
    t0 = time.perf_counter()
    eng4.refresh_sparse_head(params2)
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    after = counters.snapshot()
    work = {c: after.get(c, 0) - before.get(c, 0)
            for c in ("partition", "build_ehyb", "pack_staircase",
                      "group_er", "ehyb_refill", "kernels.nvcc",
                      "kernels.load")}
    obj1 = eng4.sparse_head.op.obj
    w_now[0] = 2.0 * w_dense
    watch(eng4, 4)
    n_err = len(head_errs)
    done = serve(eng4, range(1), uid0=200, new=2)
    del eng4._head_logits
    refresh_err = max(head_errs[n_err:])
    log("serve-refresh", seconds=round(t_refresh, 3), structure_work=work,
        structure_shared=obj1.packed_cols is obj0.packed_cols,
        head_applies=len(head_errs) - n_err,
        next_step_vs_doubled_f32=refresh_err)
    check(all(v == 0 for v in work.values()),
          f"the refresh made no structure pass: {work}")
    check(obj1.packed_cols is obj0.packed_cols
          and obj1.er_s_cols is obj0.er_s_cols, "the structure is shared")
    check(len(done) == 1 and refresh_err <= 1e-4,
          "the next step's logits follow the refreshed weights")

    # -- chaos: the sparse head fails on every call; the engine degrades to
    #    the dense head and finishes what it admitted; restore ---------------
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReliabilityWarning)
        with chaos(fail_sparse_apply=True) as ccfg:
            done = serve(eng4, range(4), uid0=300)
    degraded = eng4.degraded
    log("serve-chaos", injected=dict(ccfg.injected), degraded=degraded,
        reason=repr(eng4.degraded_reason), requests=len(done),
        tokens=[len(r.generated) for r in done],
        retries=eng4.stats["retries"])
    check(ccfg.injected["serve:sparse"] >= 1 and degraded,
          "the failing sparse head degraded the engine")
    check(len(done) == 4 and all(len(r.generated) == SERVE_NEW
                                 for r in done),
          "the degraded engine finished every admitted request")
    eng4.restore_sparse_head()
    resolve(eng4, 4)                     # chaos moved the guard's epoch
    n0 = KM.ehyb_packed_fused_spmm.launches
    done = serve(eng4, range(1), uid0=400, new=2)
    torch.cuda.synchronize()
    check(not eng4.degraded and len(done) == 1
          and KM.ehyb_packed_fused_spmm.launches > n0,
          "restore_sparse_head serves the sparse head (#8) again")
    healthy("serve-chaos")

    # -- #8 and #2 against their plain versions on the heads' containers,
    #    then their times beside the bound, the dense head and torch CSR ----
    o4, o1 = eng4.sparse_head.op.obj, head1.op.obj
    x4 = eng4.sparse_head.to_permuted(last_h[4].float()).reshape(
        -1, o4.n_pad).T.contiguous()                         # (n_pad, 4)
    x1 = head1.to_permuted(last_h[1].float()).reshape(o1.n_pad)
    st4 = (o4.packed_vals, o4.packed_cols, o4.col_starts, o4.col_rows)
    st1 = (o1.packed_vals, o1.packed_cols, o1.col_starts, o1.col_rows)
    cases = {
        "ehyb_packed_fused_spmm": (
            lambda: KM.ehyb_packed_fused_spmm(
                x4, *st4, o4.er_stream(), vec_size=o4.vec_size,
                rhs_chunk=o4.rhs_chunk),
            lambda: ref.ehyb_packed_fused_stream_ref(
                x4, *st4, o4.er_stream(), o4.vec_size)),
        "ehyb_packed_fused": (
            lambda: K.ehyb_packed_fused(
                x1, *st1, o1.er_stream(), vec_size=o1.vec_size,
                has_er=o1.has_er),
            lambda: ref.ehyb_packed_fused_stream_ref(
                x1[:, None], *st1, o1.er_stream(), o1.vec_size,
                o1.has_er)[:, 0]),
    }
    chk = check_cases(cases, KERNEL_TOL["float32"], "serve head")
    h4 = last_h[4][:, 0].float()                             # (4, d)
    h4b, w_b = h4.bfloat16(), w_dense.bfloat16()
    with warnings.catch_warnings():           # torch's sparse-CSR notices
        warnings.simplefilter("ignore", UserWarning)
        w_t = torch.sparse_csr_tensor(        # the library yardstick
            torch.as_tensor(w_sp.indptr, dtype=torch.int64, device=dev),
            torch.as_tensor(w_sp.indices, dtype=torch.int64, device=dev),
            torch.as_tensor(w_sp.data, dtype=torch.float32, device=dev),
            size=w_sp.shape, check_invariants=False)
    h4t, h1t = h4.T.contiguous(), h4[:1].T.contiguous()
    er_rows = {s: int(engines[s].sparse_head.ehyb.fill_plan["n_er_live"])
               for s in SERVE_SLOTS}
    rows_out = {}
    for name, slots, o, k in (("ehyb_packed_fused_spmm", 4, o4, 4),
                              ("ehyb_packed_fused", 1, o1, 1)):
        e = engines[slots].sparse_head.ehyb
        kern, plain = cases[name]
        hx = h4t if k == 4 else h1t
        bd, by = spmv_bound(o.n_pad, e.nnz_in, int(csr.nnz - e.nnz_in),
                            er_rows[slots], 4, k)
        row = {"kernel_ms": time_ms(kern, dev),
               "plain_ms": time_ms(plain, dev),
               "library_ms": time_ms(lambda: w_t @ hx, dev),
               "dense_f32_ms": time_ms(lambda: torch.matmul(
                   h4[:k], w_dense.T), dev),
               "dense_bf16_ms": time_ms(lambda: torch.matmul(
                   h4b[:k], w_b.T), dev),
               "bound_ms": bd, "bound_by": by}
        rows_out[name] = row
        log("serve-head-time", card=repr(smi), kernel=name, slots=slots,
            k=k, n_pad=o.n_pad, n_parts=o.n_parts, vec_size=o.vec_size,
            nnz_in=e.nnz_in, nnz_er=int(csr.nnz - e.nnz_in),
            er_share=round(1 - e.nnz_in / csr.nnz, 4),
            er_rows=er_rows[slots], vs_plain=chk[name][0],
            bound_share=round(bd / row["kernel_ms"], 4), **row)
    lib_err = rel_err((w_t @ h4t).T.cpu(), (h4 @ w_dense.T).cpu())
    log("serve-bytes", library_vs_dense=lib_err,
        **{f"bytes_{k}": v for k, v in head4.bytes_vs_dense().items()})
    healthy("serve-times")
    log("serve-phase", seconds=round(time.perf_counter() - t_phase, 3))
    out = {"ehyb_packed_fused_spmm": launches[4]["ehyb_packed_fused_spmm"],
           "ehyb_packed_fused": launches[1]["ehyb_packed_fused"]}
    del engines, params, params2, w_dense, w_b, w_t, head4, head1
    # the spies on the engines' methods close over the engines (a cycle):
    # without a collection their weights stay on the card
    gc.collect()
    torch.cuda.empty_cache()
    return out


def step_vs_cpu(p0, p_card, p_cpu, g_cpu, g_card, cfg, opt_cfg,
                lr: float, device=None) -> list:
    """One train step on the card against the same step on the CPU, leaf by
    leaf (all trees on the CPU; ``p0`` the weights both started from).

    The step is held in its two halves: the gradients that reach AdamW
    (``grad_vs_cpu``: max|Δg| over the leaf's largest gradient), and the
    card's AdamW against the CPU's AdamW on the card's gradients
    (``adamw_vs_cpu_lr``, in units of the step's lr).  The stepped weights
    are held to what AdamW makes of the gradients' difference: its first
    step moves a weight by lr·s(ĝ), s(ĝ) = ĝ/(|ĝ| + eps) with ĝ the clipped
    gradient, so gradients that differ near eps move a weight differently
    by up to 2·lr; ``excess_lr`` is the most any weight moved beyond
    lr·|s(ĝ_card) − s(ĝ_cpu)|.  ``worst_*`` describe the weight whose step
    differs most.  With ``device`` each leaf is compared there (the trees
    stay where they are)."""
    import torch

    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import adamw_update, global_norm, init_opt_state

    def names(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from names(v, f"{prefix}{k}/")
            else:
                yield prefix + k

    def clip_scale(g):
        n = global_norm(g)
        return torch.clamp(opt_cfg.clip_norm / torch.clamp(n, min=1e-9),
                           max=1.0)

    # leaf by leaf (a full-width model's trees are held a few at a time):
    # the clipped gradients, and AdamW's first step from p0 on the card's
    no_clip = dataclasses.replace(opt_cfg, clip_norm=float("inf"))
    k_c, k_g = clip_scale(g_cpu), clip_scale(g_card)
    rows = []
    for name, *leaves in zip(names(p0), *(tree_leaves(t) for t in (
            p0, p_card, p_cpu, g_cpu, g_card))):
        p, a, b, gc, gg = (t.to(device or t.device) for t in leaves)
        hc, hg = (gc * k_c.to(gc.device, gc.dtype),
                  gg * k_g.to(gg.device, gg.dtype))
        r = adamw_update({"w": p}, {"w": hg}, init_opt_state(
            {"w": p}, cfg.opt_state_dtype), no_clip)[0]["w"]
        d = (a - b).abs()
        s_g, s_c = (h / (h.abs() + opt_cfg.eps) for h in (hg, hc))
        j = int(d.argmax())
        rows.append({
            "leaf": name,
            "grad_vs_cpu": float((gg - gc).abs().max()
                                 / max(float(gc.abs().max()), 1e-30)),
            "adamw_vs_cpu_lr": float((a - r).abs().max()) / lr,
            "step_vs_cpu_lr": float(d.max()) / lr,
            "excess_lr": float((d / lr - (s_g - s_c).abs()).max()),
            "worst_g_cpu": float(hc.flatten()[j]),
            "worst_g_card": float(hg.flatten()[j]),
            "leaf_g_max": float(hc.abs().max())})
    return rows


def train_phase(dev, smi: str, plans: list, all_kernels: dict,
                healthy) -> dict:
    """The train main path (phase 11g).

    1. llama3_2_1b at full width and depth (16 layers, d 2048, 32/8 heads,
       d_ff 8192, vocab 128,256 padded to 129,024; fp32 master weights,
       bf16 compute, fp32 moments, ``microbatches=2`` and ``remat`` as the
       config has them) through ``launch.train.build_trainer`` and
       ``ResilientTrainer.run``: 4 steps of 4 × 512 tokens, whose only
       save is the run's final blocking one (params + m + v); each step's
       ms and tokens a second, loss and grad norm, peak memory; then 6
       steps on one fixed batch, whose loss must fall.  The final save is
       called but not written: the 14.8 GB round trip to disk took ~58 s
       of the script's time limit, and the same save and restore run
       below at 2 layers (4.6 GB, bit for bit) and in 11h.  No hand-written kernel may launch here: the dense
       train step reaches none, as the reference's reaches no Pallas one.
    2. The same at 2 layers: 4 steps straight against 2 steps, a save, a
       restore into a fresh template and 2 more (losses within 1e-3:
       ``index_add_`` and the embedding's backward accumulate with
       atomics); and a run with a failure injected at step 3, restored
       from the latest checkpoint, which must finish.
    3. Fixed-mask value training on #8: the llama3_2_1b FFN down
       projection (2,048 × 8,192) pruned to density 0.2, ``ehyb_packed``
       on bfs, 64 tokens, 5 steps of ``make_sparse_value_train_step``
       with AdamW, counts from 0: #8 at least 5 launches and no other
       kernel, the loss falling on every step; the values' gradient
       against a float64 oracle within 1e-4 of the largest.
    4. moonshot, grok, rwkv6 and jamba at their smoke configs on the card
       against the port's own CPU run of the same weights (forward and
       loss, one train step, prefill and 4 decode steps), each within
       1e-4 of the largest.

    Returns the main path's launches {kernel: n}."""
    import dataclasses as dc

    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.api import pruned_linear
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.kernels import ehyb_spmm as KM
    from repro_torch.kernels import ref
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_model, prefill)
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train import (OptimizerConfig, adamw_update,
                                   init_opt_state, init_train_state,
                                   make_loss_fn, make_sparse_value_train_step,
                                   make_train_step)
    from repro_torch.train import train_step as TS

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # what the earlier phases still hold on the card: the phase's peak is
    # read above this base
    base = torch.cuda.memory_allocated(dev)
    log("train-memory-before", allocated_bytes=base,
        reserved_bytes=torch.cuda.memory_reserved(dev))
    cfg = get_config("llama3_2_1b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.dtype, cfg.param_dtype,
           cfg.opt_state_dtype, cfg.microbatches, cfg.remat)
          == (16, 2048, 32, 8, 8192, 128256, "bfloat16", "float32",
              "float32", 2, True), "llama3_2_1b at full width and depth")
    opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    (ROOT / "build").mkdir(exist_ok=True)

    def state_leaves(st):
        return [*tree_leaves(st.params), *tree_leaves(st.opt.m),
                *tree_leaves(st.opt.v), st.opt.step, st.step]

    def timed_saves(trainer, out: list, write: bool = True) -> None:
        save = trainer.ckpt.save

        def timed(step, tree, extra=None, blocking=True):
            t0 = time.perf_counter()
            if write:
                save(step, tree, extra, blocking)
            out.append((step, time.perf_counter() - t0, blocking))

        trainer.ckpt.save = timed

    # -- 1. full width, full depth: 4 steps, the final save called ---------
    for fn in all_kernels.values():
        fn.launches = 0
    ckpt_dir = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build"))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer, state = build_trainer(cfg, opt_cfg, device=dev,
                                   global_batch=TRAIN_BATCH,
                                   seq_len=TRAIN_SEQ, ckpt_dir=ckpt_dir,
                                   ckpt_every=TRAIN_STEPS + 1, seed=SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in state_leaves(state))
    disk = shutil.disk_usage(ckpt_dir)
    log("train-setup", model=cfg.name, card=repr(smi), params=n_params,
        state_bytes=state_bytes, init_s=round(t_init, 3),
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=cfg.microbatches,
        remat=cfg.remat, disk_free_bytes=disk.free,
        disk_total_bytes=disk.total)
    saves = []
    timed_saves(trainer, saves, write=False)
    retries0 = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    state, hist = trainer.run(state, 0, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries",
                                                0) - retries0
    step_ms = [h["seconds"] * 1e3 for h in hist]
    log("train-full", steps=len(hist), step_ms=step_ms,
        tokens_per_s=[tokens / h["seconds"] for h in hist],
        loss=[h["loss"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist],
        lr=[h["lr"] for h in hist], peak_bytes=peak,
        phase_peak_bytes=peak - base, alloc_retries=retries,
        saves_called=saves, checkpoint_written=False,
        stragglers=len(trainer.watchdog.flagged))
    check(len(hist) == TRAIN_STEPS and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
        for h in hist), "finite loss and grad norm on every step")
    check(len(saves) == 1 and saves[0][0] == TRAIN_STEPS and saves[0][2],
          f"the run's only save is its final blocking one: {saves}")
    check(int(state.step) == TRAIN_STEPS
          and int(state.opt.step) == TRAIN_STEPS, "the state counted 4 steps")
    # overfit one fixed batch
    fixed = trainer.batch_fn(0)
    over, over_ms = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        state, met = trainer.step_fn(state, fixed)
        over.append(float(met["loss"]))
        over_ms.append((time.perf_counter() - t0) * 1e3)
    log("train-overfit", loss=over, step_ms=over_ms)
    check(over[-1] < over[0], f"the loss on a fixed batch falls: {over}")
    # where a step's time goes: a profiler trace of one more step; device
    # busy time against the unprofiled steps' median.  The least time of
    # a step: its matmuls (6 flops a parameter and token, plus attention's
    # QKᵀ and PV) at the bf16 peak, or AdamW's bytes (read p, g, m, v and
    # write p, m, v, fp32) at the memory rate
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, met = trainer.step_fn(state, fixed)
        float(met["loss"])
        t_traced = time.perf_counter() - t0
    dev_us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and ev.self_device_time_total > 0
              and not ev.key.startswith("Activity Buffer")}
    busy_ms = sum(dev_us.values()) / 1e3
    step_med = statistics.median(over_ms)
    flops = 6 * n_params * tokens + 3 * cfg.n_layers * 4 * TRAIN_BATCH \
        * TRAIN_SEQ ** 2 * cfg.n_heads * cfg.head_dim
    flop_ms = flops / BF16_PEAK * 1e3
    opt_ms = 7 * 4 * n_params / BANDWIDTH * 1e3
    log("train-trace", card=repr(smi), unprofiled_median_ms=step_med,
        traced_wall_ms=t_traced * 1e3, device_busy_ms=busy_ms,
        idle_share=(1 - busy_ms / step_med) if busy_ms else "not measured",
        device_activities=sum(ev.count for ev in prof.key_averages()
                              if ev.key in dev_us),
        model_flops=flops, flops_bound_ms=flop_ms, adamw_bytes_ms=opt_ms,
        bound_ms=max(flop_ms, opt_ms),
        model_flops_share=flops / (step_med * 1e-3) / BF16_PEAK,
        device_ms=device_ms_by_category(dev_us),
        top_device_us=top_device_us(dev_us, 10))
    del prof
    dense_launches = {k: f.launches for k, f in all_kernels.items()}
    check(not any(dense_launches.values()),
          f"the dense train step launched a hand-written kernel: "
          f"{dense_launches}")
    del trainer, state, fixed
    shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()

    # -- 2. resume and failure at 2 layers ----------------------------------
    cfg2 = dc.replace(cfg, n_layers=2)
    t_resume = time.perf_counter()
    dirs = [Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build"))
            for _ in range(3)]

    def fresh(d, ckpt_every=1000, seed=SEED):
        return build_trainer(cfg2, opt_cfg, device=dev,
                             global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             ckpt_dir=d, ckpt_every=ckpt_every, seed=seed)

    tr, st = fresh(dirs[0])
    n_params2 = sum(t.numel() for t in tree_leaves(st.params))
    straight = []
    for i in range(4):
        st, met = tr.step_fn(st, tr.batch_fn(i))
        straight.append(float(met["loss"]))
    del tr, st
    tr, st = fresh(dirs[1])
    resumed = []
    for i in range(2):
        st, met = tr.step_fn(st, tr.batch_fn(i))
        resumed.append(float(met["loss"]))
    t0 = time.perf_counter()
    tr.ckpt.save(2, st)
    t_save2 = time.perf_counter() - t0
    ck2_bytes = (dirs[1] / f"step_{2:010d}.npz").stat().st_size
    del st
    template = init_train_state(init_model(SEED + 1, cfg2, device=dev), cfg2)
    t0 = time.perf_counter()
    st = tr.ckpt.restore(2, template)
    torch.cuda.synchronize()
    t_restore2 = time.perf_counter() - t0
    del template
    for i in range(2, 4):
        st, met = tr.step_fn(st, tr.batch_fn(i))
        resumed.append(float(met["loss"]))
    del tr, st
    tr, st = fresh(dirs[2], ckpt_every=2)
    fired = []

    def injector(i):
        if i == 3 and not fired:
            fired.append(i)
            raise RuntimeError("injected failure")

    tr.failure_injector = injector
    st, hist2 = tr.run(st, 0, 4)
    survived = [h["loss"] for h in hist2]
    gap = max(abs(a - b) for a, b in zip(straight, resumed))
    gap_fail = abs(hist2[-1]["loss"] - straight[-1])
    log("train-resume", layers=cfg2.n_layers, params=n_params2,
        checkpoint_bytes=ck2_bytes, save_s=round(t_save2, 3),
        restore_s=round(t_restore2, 3), straight=straight, resumed=resumed,
        max_gap=gap, failure_steps=[h["step"] for h in hist2],
        failure_loss=survived, failure_vs_straight=gap_fail,
        failures_fired=len(fired), latest=tr.ckpt.latest_step(),
        seconds=round(time.perf_counter() - t_resume, 3))
    check(gap <= 1e-3, f"resume agrees with the straight run: {gap}")
    check(fired == [3] and [h["step"] for h in hist2] == [0, 1, 2, 2, 3]
          and tr.ckpt.latest_step() == 4 and gap_fail <= 1e-3,
          "the injected failure was restored from step 2 and the run "
          "finished")
    del tr, st
    for d in dirs:
        shutil.rmtree(d)
    torch.cuda.empty_cache()

    # -- 3. fixed-mask value training on #8 ----------------------------------
    rng = np.random.default_rng(SEED + 7)
    w_down = rng.standard_normal((D_FF, D_MODEL)) / np.sqrt(D_FF)
    t0 = time.perf_counter()
    lin = pruned_linear(w_down.T, density=VALUE_DENSITY,
                        format="ehyb_packed", partition_method="bfs",
                        k=VALUE_TOKENS, device=dev)
    t_lin = time.perf_counter() - t0
    vplan = lin.op.plan
    plans.append(vplan)
    n = lin.op.n
    x_host = rng.standard_normal((VALUE_TOKENS, D_FF))
    xt = torch.as_tensor(x_host.T[:n], dtype=torch.float32, device=dev)
    y_goal_host = (x_host @ w_down).T                      # (d_model, T)
    y_goal = torch.as_tensor(y_goal_host, dtype=torch.float32, device=dev)

    def loss_fn(op):
        d = (op @ xt)[:D_MODEL] - y_goal
        return (d * d).sum() / d.numel()

    v0 = lin.values.detach().clone()
    # the guard resolves (its probe launches #8 once) before counting
    lin.op @ torch.zeros_like(xt)
    # the gradient at v0 against a float64 oracle (a comparison launch)
    c = lin.csr
    rows = np.repeat(np.arange(c.n), c.row_lengths())
    cols = c.indices.astype(np.int64)
    v = v0.clone().requires_grad_(True)
    loss_fn(vplan.bind(v, validate=False)).backward()
    xt64 = x_host.T[:n]
    y64 = sp.csr_matrix((v0.double().cpu().numpy(), c.indices, c.indptr),
                        shape=(n, n)) @ xt64
    g_y = np.zeros_like(y64)
    g_y[:D_MODEL] = 2.0 * (y64[:D_MODEL] - y_goal_host) / y_goal_host.size
    g_ref = np.einsum("kt,kt->k", g_y[rows], xt64[cols])
    g_err = rel_to_largest(v.grad.cpu(), g_ref)
    del v
    step = make_sparse_value_train_step(
        vplan, loss_fn, OptimizerConfig(lr=VALUE_LR, warmup_steps=0,
                                        weight_decay=0.0, clip_norm=1e9))
    opt = init_opt_state({"values": v0})
    vals = v0
    for fn in all_kernels.values():
        fn.launches = 0
    losses, step_ms = [], []
    for _ in range(VALUE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, opt, met = step(vals, opt)
        losses.append(float(met["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: f.launches for k, f in all_kernels.items()}
    # #8 against its plain version at the value step's shape (K = 64) on the
    # container of the trained values (comparison launches, not counted)
    o = vplan.bind(vals, validate=False).obj
    x_new = lin.op.to_space(xt).contiguous()              # (n_pad, 64)
    stair = (o.packed_vals, o.packed_cols, o.col_starts, o.col_rows)
    chk = check_cases({"ehyb_packed_fused_spmm": (
        lambda: KM.ehyb_packed_fused_spmm(x_new, *stair, o.er_stream(),
                                          vec_size=o.vec_size,
                                          rhs_chunk=o.rhs_chunk),
        lambda: ref.ehyb_packed_fused_stream_ref(x_new, *stair, o.er_stream(),
                                                 o.vec_size))},
        KERNEL_TOL["float32"], "value step")["ehyb_packed_fused_spmm"]
    log("train-values", shape=(D_MODEL, D_FF), density=VALUE_DENSITY,
        nnz=c.nnz, tokens=VALUE_TOKENS, format=lin.op.format,
        n_parts=vplan.n_parts, vec_size=vplan.vec_size,
        setup_s=round(t_lin, 3), loss=losses, step_ms=step_ms,
        grad_vs_f64=g_err, launches=launches, kernel_k=x_new.shape[1],
        kernel_vs_plain=chk[0], kernel_max_abs_err=chk[1],
        degraded=vplan.degraded)
    check(launches["ehyb_packed_fused_spmm"] >= VALUE_STEPS
          and sum(launches.values())
          == launches["ehyb_packed_fused_spmm"],
          f"the value steps launched #8 (and nothing else): {launches}")
    check(g_err <= 1e-4, f"the values' gradient against float64: {g_err}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"the loss falls on every step: {losses}")
    check(vplan.degraded == {}, f"the value plan degraded: "
          f"{vplan.degraded}")
    out = {"ehyb_packed_fused_spmm": launches["ehyb_packed_fused_spmm"]}
    max_abs = {"ehyb_packed_fused_spmm": chk[1]}
    del lin, xt, y_goal, vals, opt, v0, o, x_new, stair
    torch.cuda.empty_cache()

    # -- 4. the four new architectures: the card against the CPU ------------
    def t2n(t):
        return t.detach().float().cpu().numpy()

    seen = []                     # the gradients each step hands AdamW

    def spy(params, grads, *args, **kw):
        seen.append(tree_map(lambda g: g.detach().cpu().clone(), grads))
        return adamw_update(params, grads, *args, **kw)

    arch_cfg = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    TS.adamw_update = spy
    try:
        for arch in NEW_ARCHS:
            t_arch = time.perf_counter()
            cfg_s = get_config(arch, smoke=True)
            if cfg_s.n_experts:     # no capacity drops (as the reference's
                cfg_s = dc.replace(cfg_s, capacity_factor=8.0)  # decode test)
            p_cpu = init_model(SEED, cfg_s, device="cpu")
            ds = SyntheticTokenDataset(cfg_s.vocab_size, 32, 2, seed=SEED)
            batch = ds.train_inputs(0)
            res, steps = {}, {}
            seen.clear()
            for where in ("cpu", dev):
                p = tree_map(lambda t: t.to(where), p_cpu)
                b = {k: torch.from_numpy(v).to(where)
                     for k, v in batch.items()}
                with torch.no_grad():
                    h, _ = forward(p, b, cfg_s)
                    loss, _ = make_loss_fn(cfg_s)(p, b)
                st = init_train_state(tree_map(torch.clone, p), cfg_s)
                st, met = make_train_step(cfg_s, arch_cfg)(st, b)
                steps[str(where)] = (tree_map(lambda t: t.cpu(), st.params),
                                     float(met["lr"]))
                with torch.no_grad():
                    loss_after, _ = make_loss_fn(cfg_s)(st.params, b)
                    ds_ = init_decode_state(cfg_s, 2, 64, torch.float32,
                                            device=where)
                    hs = []
                    h_last, ds_ = prefill(p, {"tokens": b["tokens"][:, :16]},
                                          cfg_s, ds_)
                    hs.append(h_last)
                    for j in range(4):
                        hd, ds_ = decode_step(
                            p, b["tokens"][:, 16 + j:17 + j], cfg_s, ds_,
                            16 + j)
                        hs.append(hd)
                res[str(where)] = {
                    "h": t2n(h), "loss": t2n(loss),
                    "step_loss": t2n(met["loss"]),
                    "grad_norm": t2n(met["grad_norm"]),
                    "loss_after": t2n(loss_after),
                    "decode": np.stack([t2n(t) for t in hs])}
            ref_, got = res["cpu"], res[str(dev)]
            errs = {k: rel_to_largest(got[k], ref_[k]) for k in ref_}
            (p_c, lr), (p_g, _) = steps["cpu"], steps[str(dev)]
            rows = step_vs_cpu(p_cpu, p_g, p_c, *seen, cfg_s, arch_cfg, lr)
            worst = max(rows, key=lambda r: r["step_vs_cpu_lr"])
            bad = [r for r in rows if r["grad_vs_cpu"] > 1e-4
                   or r["adamw_vs_cpu_lr"] > 1e-2 or r["excess_lr"] > 1e-2]
            log("train-arch", arch=arch, family=cfg_s.family,
                seconds=round(time.perf_counter() - t_arch, 3),
                loss=float(got["loss"]),
                **{f"{k}_vs_cpu": v for k, v in errs.items()},
                grad_vs_cpu=max(r["grad_vs_cpu"] for r in rows),
                adamw_vs_cpu_lr=max(r["adamw_vs_cpu_lr"] for r in rows),
                step_excess_lr=max(r["excess_lr"] for r in rows),
                step_worst=worst, eps=arch_cfg.eps)
            check(max(errs.values()) <= 1e-4 and np.isfinite(got["loss"])
                  and not bad, f"{arch} on the card against the CPU: "
                  f"{errs} {bad}")
    finally:
        TS.adamw_update = adamw_update
    healthy("train")
    log("train-phase", seconds=round(time.perf_counter() - t_phase, 3))
    return out, max_abs


def mesh_phase(dev, smi: str, all_kernels: dict) -> list:
    """The mesh path (phase 11h), in its own one-rank NCCL group (an
    in-memory store), destroyed at its end; the card machine has one card,
    so every group is one rank's, and ``shard_ctx`` skips the collectives
    on it (each is the identity there); the gloo tests hold them.

    a. llama3_2_1b at full width and depth through ``build_trainer(...,
       mesh=make_host_mesh(1, 1, "cuda"))`` (the state ``DTensor``s placed
       by ``launch.sharding``'s rules; each unit's parameters gathered
       inside its remat boundary, each gradient reduced to its leaf's spec;
       every step under the tensor-parallel context ``tp=("model",)``,
       checked, with the leaves ``tp_layout`` keeps on `model` counted)
       against 11g's unsharded trainer on the same seed, batches (4 × 512
       tokens) and optimizer: three steps each, the losses within 1e-6
       relative, the first step's weights held as ``step_vs_cpu`` holds
       the card to the CPU (gradients within 1e-4 of each leaf's largest,
       AdamW within 1 % of lr, the step within 1 % of lr beyond what AdamW
       makes of the gradients' difference); step ms, and each run's peak
       memory above what was held when it began (the plain run's copies
       are held through the mesh run).
    b. One MoE layer at moonshot_v1_16b_a3b's full width (d 2048, 64
       experts, top-6, expert d_ff 1408) on 2,048 tokens in fp32 through
       ``_apply_moe_dist`` on the mesh (the a2a path) and through the local
       path: y, aux and the gradients of x and of every expert weight within
       1e-5 of the largest, both times; the same for grok's ``"ffn"`` mode
       at smoke size.
    c. A 2-layer state after one unsharded step, saved and restored onto
       the mesh (``CheckpointManager.restore`` with a sharded template),
       gathered back bit for bit.
    d. ``launch.dryrun``'s argument half over every (architecture × shape
       × production mesh) cell: the count of OK, SKIP and FAIL cells and
       how many fit this card's memory (their arguments; 11i costs the
       steps).

    No hand-written kernel may launch: the dense step and the MoE reach
    none, as the reference's reach no Pallas kernel.  Returns the mesh
    step's ms (a step each)."""
    import dataclasses as dc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (distribute_state, gather_state,
                                             param_specs, tp_layout)
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import init_model, shard_ctx
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train import (CheckpointManager, OptimizerConfig,
                                   adamw_update, init_train_state, lr_at)
    from repro_torch.train import train_step as TS

    t_phase = time.perf_counter()
    for fn in all_kernels.values():
        fn.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, "cuda")
        # -- a. the mesh train step at full width against 11g's -------------
        cfg = get_config("llama3_2_1b")
        opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=100)
        ckpt_root = Path(tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build"))
        seen = []

        def spy(params, grads, *args, **kw):    # the first step's
            if not seen:
                seen.append(tree_map(lambda g: g.detach().cpu(), grads))
            return adamw_update(params, grads, *args, **kw)

        def steps(m):
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            tr, st = build_trainer(cfg, opt_cfg, mesh=m, device=dev,
                                   global_batch=TRAIN_BATCH,
                                   seq_len=TRAIN_SEQ,
                                   ckpt_dir=ckpt_root / str(m is None),
                                   seed=SEED)
            # the copies kept for the comparison wait in host memory: the
            # card holds one trainer's state at a time
            p0 = None if m else tree_map(lambda t: t.cpu(), st.params)
            losses, ms, p1 = [], [], None
            for i in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, met = tr.step_fn(st, tr.batch_fn(i))
                losses.append(float(met["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    p1 = tree_map(lambda t: (t.to_local() if m else t)
                                  .cpu(), st.params)
            peak = torch.cuda.max_memory_allocated(dev) - held
            del tr, st
            gc.collect()
            torch.cuda.empty_cache()
            return p0, p1, losses, ms, peak

        tp_seen = []
        set_ctx = shard_ctx.set_sharding_context

        def ctx_spy(m, batch_axes, split=(), tp=(), seq=()):  # the steps'
            tp_seen.append(tuple(tp))
            return set_ctx(m, batch_axes, split=split, tp=tp, seq=seq)

        TS.adamw_update = spy
        shard_ctx.set_sharding_context = ctx_spy
        try:
            p0, p_plain, l_plain, ms_plain, peak_plain = steps(None)
            g_plain = seen[0]
            seen.clear()
            _, p_mesh, l_mesh, ms_mesh, peak_mesh = steps(mesh)
            g_mesh = seen[0]
        finally:
            TS.adamw_update = adamw_update
            shard_ctx.set_sharding_context = set_ctx
        seen.clear()
        layout = tp_layout(param_specs(p0, mesh, cfg), mesh, cfg)
        kept = sum(keep == ("model",) for keep, _ in tree_leaves(layout))
        rows = step_vs_cpu(p0, p_mesh, p_plain, g_plain, g_mesh, cfg,
                           opt_cfg, float(lr_at(opt_cfg, 1)), device=dev)
        bad = [r for r in rows if r["grad_vs_cpu"] > 1e-4
               or r["adamw_vs_cpu_lr"] > 1e-2 or r["excess_lr"] > 1e-2]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_mesh, l_plain))
        log("mesh-train", card=repr(smi), model=cfg.name, mesh="(1, 1)",
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, loss_mesh=l_mesh,
            loss_plain=l_plain, loss_rel_gap=loss_gap, step_ms_mesh=ms_mesh,
            step_ms_plain=ms_plain, peak_bytes_mesh=peak_mesh,
            peak_bytes_plain=peak_plain, base_bytes=base,
            grad_vs_plain=max(r["grad_vs_cpu"] for r in rows),
            adamw_vs_plain_lr=max(r["adamw_vs_cpu_lr"] for r in rows),
            step_excess_lr=max(r["excess_lr"] for r in rows),
            step_worst=max(rows, key=lambda r: r["step_vs_cpu_lr"]),
            tp_context=sorted(set(tp_seen)), leaves_kept_on_model=kept)
        check(loss_gap <= 1e-6, f"the mesh step's losses against 11g's: "
              f"{l_mesh} {l_plain}")
        check(len(tp_seen) == 3 and set(tp_seen) == {("model",)},
              f"the mesh steps' tensor-parallel context: {tp_seen}")
        check(not bad, f"the mesh step's weights against 11g's: {bad}")
        del p0, p_plain, p_mesh, g_plain, g_mesh, rows
        gc.collect()
        torch.cuda.empty_cache()

        # -- b. the distributed MoE at moonshot's full width ----------------
        moe_out = {}
        for arch, smoke, tokens in (("moonshot_v1_16b_a3b", False, 2048),
                                    ("grok_1_314b", True, 256)):
            mcfg = dc.replace(get_config(arch, smoke=smoke), dtype="float32")
            gen = torch.Generator(dev).manual_seed(SEED)
            p_init = M.init_moe(gen, mcfg)
            x_init = torch.randn((tokens // 512 if tokens >= 512 else 1,
                                  min(tokens, 512), mcfg.d_model),
                                 generator=gen, device=dev)
            c = torch.randn(x_init.shape, generator=gen, device=dev)
            outs, times = [], {}
            for path in ("dist", "local"):
                ts_ = []
                for _ in range(3):
                    p = {k: v.clone().requires_grad_(True)
                         for k, v in p_init.items()}
                    x = x_init.clone().requires_grad_(True)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y, aux = (M._apply_moe_dist(p, x, mcfg, mesh, ("data",))
                              if path == "dist"
                              else M._apply_moe_local(p, x, mcfg))
                    ((y * c).sum() + aux).backward()
                    torch.cuda.synchronize()
                    ts_.append((time.perf_counter() - t0) * 1e3)
                times[path] = statistics.median(ts_)
                outs.append({"y": y.detach(), "aux": aux.detach(),
                             "x": x.grad, **{k: v.grad for k, v in p.items()}})
            errs = {k: rel_to_largest(outs[0][k].cpu(), outs[1][k].cpu())
                    if outs[1][k].ndim else
                    abs(float(outs[0][k] - outs[1][k]))
                    for k in outs[1]}
            split = M.moe_split(x_init.shape[0] * x_init.shape[1], mesh,
                                ("data",), mcfg)
            log("mesh-moe", arch=arch, smoke=smoke, d_model=mcfg.d_model,
                experts=mcfg.n_experts, top_k=mcfg.top_k, d_ff=mcfg.d_ff,
                tokens=tokens, split=split, dist_fwd_bwd_ms=times["dist"],
                local_fwd_bwd_ms=times["local"], errs=errs)
            check(max(errs.values()) <= 1e-5,
                  f"{arch}: the distributed MoE against the local path: "
                  f"{errs}")
            moe_out[arch] = split
            del outs, p_init, x_init, c
        check(moe_out["moonshot_v1_16b_a3b"][2]
              and not moe_out["grok_1_314b"][2],
              f"the a2a path on moonshot, not on grok: {moe_out}")

        # -- c. an unsharded 2-layer state restored onto the mesh ----------
        cfg2 = dc.replace(cfg, n_layers=2)
        tr, st = build_trainer(cfg2, opt_cfg, device=dev,
                               global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                               ckpt_dir=ckpt_root / "c", seed=SEED)
        st, _ = tr.step_fn(st, tr.batch_fn(0))
        t0 = time.perf_counter()
        tr.ckpt.save(1, st)
        t_save = time.perf_counter() - t0
        tmpl = distribute_state(init_train_state(
            init_model(SEED + 1, cfg2, device=dev), cfg2), mesh, cfg2)
        t0 = time.perf_counter()
        on_mesh = CheckpointManager(str(ckpt_root / "c")).restore(1, tmpl)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        back = gather_state(on_mesh)

        def leaves(x):
            return [*tree_leaves(x.params), *tree_leaves(x.opt.m),
                    *tree_leaves(x.opt.v), x.opt.step, x.step]

        same = all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                     leaves(st)))
        log("mesh-restore", layers=2, save_s=round(t_save, 3),
            restore_s=round(t_restore, 3), bit_identical=same,
            placements=str(on_mesh.params["embed"]["embedding"].placements))
        check(same, "the 2-layer state restored onto the mesh bit for bit")
        del tr, st, tmpl, on_mesh, back
        shutil.rmtree(ckpt_root)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # -- d. the dry run over every cell ---------------------------------------
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(dev).total_memory
    counts = collections.Counter()
    fit = {}
    for multi in (False, True):
        for arch in ARCH_IDS:
            for name in SHAPES:
                rec = dryrun.run_cell(arch, name, multi, force=True,
                                      verbose=False, device_bytes=total,
                                      cost=False)
                counts[rec["status"]] += 1
                if rec["status"] == "OK":
                    fit[f"{arch}|{name}|{rec['mesh']}"] = (
                        rec["memory"]["argument_bytes"], rec["fits"])
    largest = max(fit.items(), key=lambda kv: kv[1][0])
    log("mesh-dryrun", card=repr(smi), total_memory=total,
        ok=counts["OK"], skip=counts["SKIP"], fail=counts["FAIL"],
        fit=sum(f for _, f in fit.values()),
        largest_cell=largest[0], largest_bytes=largest[1][0],
        seconds=round(time.perf_counter() - t0, 3))
    check(counts == {"OK": 64, "SKIP": 16}, f"dry-run cells: {counts}")
    launches = {k: f.launches for k, f in all_kernels.items()}
    check(not any(launches.values()),
          f"the mesh path launched a hand-written kernel: {launches}")
    log("mesh-phase", seconds=round(time.perf_counter() - t_phase, 3))
    return ms_mesh


# the card cell's fake run, in a process of its own (a fake group is its
# process's default group): rank 0 of one rank on a 1 × 1 CPU mesh
CARD_CELL_CHILD = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
arch, b, s, mb, scaled, out = sys.argv[1:7]
dryrun.fake_group(1)
mesh = make_host_mesh(1, 1, "cpu")
res = dryrun.cost_train_step(get_config(arch), mesh, int(b), int(s),
                             microbatches=int(mb), scaled=scaled == "1")
with open(out, "w") as f:
    json.dump(res, f)
"""
ROOFLINE_CELLS = ("llama3_2_1b", "moonshot_v1_16b_a3b")
PEAK_TOL = 0.10                # the fake run's peak against the card's
FLOPS_TOL = 0.01               # its flops against the card step's

# phase 11j: the mesh prefill of 4 × 512 tokens, then 16 decode steps
SERVE_MESH_BATCH, SERVE_MESH_PROMPT, SERVE_MESH_STEPS = 4, 512, 16
SERVE_MESH_LEN = 1024          # the cache's depth
SERVE_MESH_TOL = 1e-4          # mesh logits against the unsharded path's


# the costed decode step's fake run, in a process of its own: rank 0 of one
# rank on a 1 × 1 CPU mesh; argv is (arch, batch, depth, pos, out file[,
# layers])
SERVE_CELL_CHILD = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
arch, b, s, pos, out = sys.argv[1:6]
cfg = get_config(arch)
if len(sys.argv) > 6:
    cfg = dataclasses.replace(cfg, n_layers=int(sys.argv[6]))
dryrun.fake_group(1)
res = dryrun.cost_serve_step(cfg, make_host_mesh(1, 1, "cpu"),
                             ShapeConfig("card", int(s), int(b), "decode"),
                             pos=int(pos))
with open(out, "w") as f:
    json.dump(res, f)
"""


def serve_in_turns(dev, cfg, params, prepared, mesh, prompt, steps,
                   cache_len: int) -> dict:
    """The unsharded and the mesh prefill of ``prompt`` (B, P) into a
    ``cache_len``-deep bf16 state, then a ``decode_step`` of each of
    ``steps`` (N, B, 1), in turns (plain, mesh, mesh, plain): each run's
    first prefill is a warm-up on a state of its own (a new group's first
    collective creates its communicator), its second is timed.  Returns
    ``{"plain": [run, run], "mesh": [run, run]}``, each run its logits,
    its final state (on the host), its ms and whether the mesh wrote the
    state it was handed."""
    import torch

    from repro_torch.models import decode_step, init_decode_state, prefill
    from repro_torch.models.transformer import serve_logits, tree_leaves

    b, p = prompt.shape
    runs = {"plain": [], "mesh": []}
    for name in ("plain", "mesh", "mesh", "plain"):
        src = prepared if name == "mesh" else params
        kw = {"mesh": mesh} if name == "mesh" else {}
        logit_kw = dict(kw, global_batch=b) if kw else {}
        for warm in (True, False):
            state = init_decode_state(cfg, b, cache_len, torch.bfloat16,
                                      device=dev)
            handed = state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                h, state = prefill(src, {"tokens": prompt}, cfg,
                                   state, **kw)
                logits = [serve_logits(src, h, cfg,
                                       **logit_kw).float()]
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            if warm:
                warm_ms = prefill_ms
                del state, handed
        ms = []
        for i in range(len(steps)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                h, state = decode_step(src, steps[i], cfg, state,
                                       p + i, **kw)
                logits.append(serve_logits(src, h, cfg,
                                           **logit_kw).float())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[name].append({
            "logits": [x.cpu() for x in logits],
            "state": [t.cpu() for t in tree_leaves(state)],
            "warm_prefill_ms": warm_ms, "prefill_ms": prefill_ms,
            "decode_ms": ms, "in_place": state is handed})
        del state, handed, h, logits
        torch.cuda.empty_cache()
    return runs


def turns_agreement(runs) -> tuple:
    """The first mesh run's logits against the first plain run's (each
    step's largest difference over the largest logit) and the largest
    such difference of their final states' leaves."""
    first = {k: v[0] for k, v in runs.items()}
    errs = [rel_to_largest(a, b_) for a, b_ in zip(
        first["mesh"]["logits"], first["plain"]["logits"])]
    state_err = max(rel_to_largest(a.float(), b_.float()) for a, b_ in
                    zip(first["mesh"]["state"], first["plain"]["state"]))
    return errs, state_err


def mesh_serve_phase(dev, smi: str, all_kernels: dict) -> None:
    """The mesh prefill and decode (phase 11j), in its own one-rank NCCL
    group (an in-memory store), destroyed at its end.

    a. llama3_2_1b at full width and depth (16 layers, d 2048, bf16
       compute, fp32 weights from ``SEED``): ``prefill`` of 4 × 512
       tokens into a 1,024-deep bf16 cache, then 16 ``decode_step``s of
       seeded tokens, unsharded and then on ``make_host_mesh(1, 1,
       "cuda")`` (``prefill(..., mesh=)``, ``decode_step(..., mesh=)``,
       ``serve_logits`` of the weights prepared once by ``mesh_params``)
       from the same weights: every
       step's logits within ``SERVE_MESH_TOL`` of the largest, the final
       caches alike, the mesh state written in place; in turns (plain,
       mesh, mesh, plain), ms of a warm-up prefill, of the timed prefill
       and of each decode step.
    b. The same decode step costed by ``roofline.op_cost``: on a fake
       1 × 1 CPU mesh in a subprocess (the dry run's replay) and on the
       card in the one-rank group under the same counter
       (``dryrun.cost_serve_step(..., fake=False)``): the fake peak
       within ``PEAK_TOL`` of ``max_memory_allocated`` above what was
       held before the arguments were built (the peak reset once they
       are), the flops within ``FLOPS_TOL``.

    No hand-written kernel may launch: the dense logits reach none."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_specs
    from repro_torch.models import init_model
    from repro_torch.models.transformer import mesh_params

    t_phase = time.perf_counter()
    for fn in all_kernels.values():
        fn.launches = 0
    cfg = get_config("llama3_2_1b")
    b, p, n = SERVE_MESH_BATCH, SERVE_MESH_PROMPT, SERVE_MESH_STEPS
    pos_cost = p + n
    tmp = Path(tempfile.mkdtemp(prefix="serve_mesh_", dir=ROOT / "build"))
    child = None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, "cuda")
        # -- a. the mesh prefill and decode against the unsharded path ------
        params = init_model(SEED, cfg, device=dev)
        prepared = mesh_params(params, cfg, mesh,
                               param_specs(params, mesh, cfg))
        gen = torch.Generator(dev).manual_seed(SEED + 11)
        prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=gen,
                               device=dev)
        steps = torch.randint(0, cfg.vocab_size, (n, b, 1), generator=gen,
                              device=dev)
        runs = serve_in_turns(dev, cfg, params, prepared, mesh, prompt,
                              steps, SERVE_MESH_LEN)
        errs, state_err = turns_agreement(runs)

        def each(name, key):
            return [r[key] for r in runs[name]]

        log("mesh-serve", card=repr(smi), model=cfg.name, mesh="(1, 1)",
            batch=b, prompt=p, decode_steps=n, cache_len=SERVE_MESH_LEN,
            order="plain mesh mesh plain",
            logits_rel_err_max=max(errs), state_rel_err=state_err,
            mesh_state_in_place=all(each("mesh", "in_place")),
            warm_prefill_ms_plain=each("plain", "warm_prefill_ms"),
            warm_prefill_ms_mesh=each("mesh", "warm_prefill_ms"),
            prefill_ms_plain=each("plain", "prefill_ms"),
            prefill_ms_mesh=each("mesh", "prefill_ms"),
            decode_ms_plain_median=[statistics.median(m) for m in
                                    each("plain", "decode_ms")],
            decode_ms_mesh_median=[statistics.median(m) for m in
                                   each("mesh", "decode_ms")],
            decode_ms_plain=each("plain", "decode_ms"),
            decode_ms_mesh=each("mesh", "decode_ms"))
        check(max(errs) <= SERVE_MESH_TOL,
              f"the mesh prefill and decode against the unsharded path: "
              f"{errs}")
        check(state_err <= SERVE_MESH_TOL, f"the mesh caches against the "
              f"unsharded path's: {state_err}")
        check(all(each("mesh", "in_place")),
              "the mesh state written in place")
        del params, prepared, runs, prompt, steps
        gc.collect()
        torch.cuda.empty_cache()

        # -- b. the decode step costed on the card and on a fake rank ---------
        # (the fake run starts after a's timings: it would share the host)
        child = subprocess.Popen(
            [sys.executable, "-c", SERVE_CELL_CHILD, cfg.name, str(b),
             str(SERVE_MESH_LEN), str(pos_cost), str(tmp / "fake.json")],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        base = torch.cuda.memory_allocated(dev)

        def ready():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)

        card = dryrun.cost_serve_step(
            cfg, mesh, ShapeConfig("card", SERVE_MESH_LEN, b, "decode"),
            fake=False, pos=pos_cost, ready=ready)
        torch.cuda.synchronize()
        peak_card = torch.cuda.max_memory_allocated(dev) - base
    finally:
        dist.destroy_process_group()
        if child is None:
            shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        _, err = child.communicate(timeout=600)
        check(child.returncode == 0, f"the decode step's fake run: "
              f"{err[-2000:]}")
        fk = json.loads((tmp / "fake.json").read_text())
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    peak_err = abs(fk["peak_bytes"] - peak_card) / peak_card
    flops_err = abs(fk["flops"] - card["flops"]) / card["flops"]
    log("mesh-serve-cost", card=repr(smi), model=cfg.name, mesh="(1, 1)",
        batch=b, cache_len=SERVE_MESH_LEN, pos=pos_cost,
        peak_predicted=fk["peak_bytes"], held_predicted=fk["held_bytes"],
        peak_card=peak_card, peak_rel_err=peak_err,
        flops_predicted=fk["flops"], flops_card=card["flops"],
        flops_rel_err=flops_err, coll_bytes=fk["coll_bytes"],
        coll_bytes_card=card["coll_bytes"], regions=fk["regions"],
        fake_s=round(fk["seconds"], 3), card_s=round(card["seconds"], 3))
    check(peak_err <= PEAK_TOL, f"the decode step's predicted peak "
          f"{fk['peak_bytes']} against the card's {peak_card}")
    check(flops_err <= FLOPS_TOL, f"the decode step's flops {fk['flops']} "
          f"against the card's {card['flops']}")
    launches = {k: f.launches for k, f in all_kernels.items()}
    check(not any(launches.values()),
          f"the mesh serve phase launched a hand-written kernel: {launches}")
    log("mesh-serve-phase", card=repr(smi),
        seconds=round(time.perf_counter() - t_phase, 3))


# phase 11k: rwkv6_7b served at full width, one Mamba block at jamba's.
# rwkv6_7b's depth is cut from 32 layers to 16: `init_model` holds every
# unit's tensors beside the stacked ones while it stacks them (2 × 30.4 GB
# fp32 at 32 layers), which with the ~23 GB the earlier phases keep does
# not fit the card (it fits when 11k runs alone)
RECURRENT_SERVE_LAYERS = 16
MAMBA_SERVE_STEPS = 4          # the Mamba block's decode steps


def recurrent_mesh_serve_phase(dev, smi: str, all_kernels: dict) -> None:
    """The mesh prefill and decode of the recurrent families (phase 11k),
    in its own one-rank NCCL group (an in-memory store), destroyed at its
    end.

    a. rwkv6_7b at full width (d 4,096, 64 heads, d_ff 14,336, bf16
       compute, fp32 weights from ``SEED``) and ``RECURRENT_SERVE_LAYERS``
       layers: ``prefill`` of 4 × 512 tokens, then 16 ``decode_step``s,
       unsharded and on ``make_host_mesh(1, 1, "cuda")`` from the same
       weights, in turns (plain, mesh, mesh, plain; :func:`serve_in_turns`):
       every step's logits within ``SERVE_MESH_TOL`` of the largest, the
       final RWKV states (shifted tokens, WKV) alike, the mesh state
       written in place; prefill and decode ms.
    b. One Mamba block at jamba_1_5_large_398b's full width (d 8,192,
       d_inner 16,384, d_state 16, dt_rank 512; its embedding and head
       around it, no FFN): the same prefill and ``MAMBA_SERVE_STEPS``
       decode steps, mesh against unsharded: the logits and the final
       conv and SSM states agree.
    c. (a)'s decode step costed by ``roofline.op_cost``: on a fake 1 × 1
       CPU mesh in a subprocess (``SERVE_CELL_CHILD``) and on the card
       in the one-rank group (``dryrun.cost_serve_step(..., fake=False)``):
       the fake peak within ``PEAK_TOL`` of ``max_memory_allocated``
       above what was held before the arguments were built, the flops
       within ``FLOPS_TOL``.

    No hand-written kernel may launch."""
    import dataclasses as dc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_specs
    from repro_torch.models import init_model
    from repro_torch.models.transformer import mesh_params

    t_phase = time.perf_counter()
    for fn in all_kernels.values():
        fn.launches = 0
    b, p, n = SERVE_MESH_BATCH, SERVE_MESH_PROMPT, SERVE_MESH_STEPS
    pos_cost = p + n
    rwkv = dc.replace(get_config("rwkv6_7b"),
                      n_layers=RECURRENT_SERVE_LAYERS)
    jamba = get_config("jamba_1_5_large_398b")
    mamba = dc.replace(jamba, name="jamba_mamba_block", n_layers=1,
                       unit_pattern=(("mamba", "none"),))
    tmp = Path(tempfile.mkdtemp(prefix="serve_rec_", dir=ROOT / "build"))
    child = None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, "cuda")
        gen = torch.Generator(dev).manual_seed(SEED + 12)
        for part, cfg, n_steps in (("a", rwkv, n), ("b", mamba,
                                                     MAMBA_SERVE_STEPS)):
            t0 = time.perf_counter()
            params = init_model(SEED, cfg, device=dev)
            prepared = mesh_params(params, cfg, mesh,
                                   param_specs(params, mesh, cfg))
            prompt = torch.randint(0, cfg.vocab_size, (b, p),
                                   generator=gen, device=dev)
            steps = torch.randint(0, cfg.vocab_size, (n_steps, b, 1),
                                  generator=gen, device=dev)
            runs = serve_in_turns(dev, cfg, params, prepared, mesh, prompt,
                                  steps, p + n_steps)
            errs, state_err = turns_agreement(runs)

            def each(name, key, runs=runs):
                return [r[key] for r in runs[name]]

            log(f"mesh-serve-recurrent-{part}", card=repr(smi),
                model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                mesh="(1, 1)", batch=b, prompt=p, decode_steps=n_steps,
                order="plain mesh mesh plain",
                logits_rel_err_max=max(errs), state_rel_err=state_err,
                state_leaves=len(runs["plain"][0]["state"]),
                mesh_state_in_place=all(each("mesh", "in_place")),
                warm_prefill_ms_plain=each("plain", "warm_prefill_ms"),
                warm_prefill_ms_mesh=each("mesh", "warm_prefill_ms"),
                prefill_ms_plain=each("plain", "prefill_ms"),
                prefill_ms_mesh=each("mesh", "prefill_ms"),
                decode_ms_plain_median=[statistics.median(m) for m in
                                        each("plain", "decode_ms")],
                decode_ms_mesh_median=[statistics.median(m) for m in
                                       each("mesh", "decode_ms")],
                decode_ms_plain=each("plain", "decode_ms"),
                decode_ms_mesh=each("mesh", "decode_ms"),
                seconds=round(time.perf_counter() - t0, 3))
            check(max(errs) <= SERVE_MESH_TOL,
                  f"{cfg.name}: the mesh prefill and decode against the "
                  f"unsharded path: {errs}")
            check(state_err <= SERVE_MESH_TOL,
                  f"{cfg.name}: the mesh state against the unsharded "
                  f"path's: {state_err}")
            check(all(each("mesh", "in_place")),
                  f"{cfg.name}: the mesh state written in place")
            del params, prepared, runs, prompt, steps
            gc.collect()
            torch.cuda.empty_cache()

        # -- c. rwkv6_7b's decode step costed on the card and on a fake rank -
        child = subprocess.Popen(
            [sys.executable, "-c", SERVE_CELL_CHILD, rwkv.name, str(b),
             str(SERVE_MESH_LEN), str(pos_cost), str(tmp / "fake.json"),
             str(rwkv.n_layers)],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        base = torch.cuda.memory_allocated(dev)

        def ready():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)

        card = dryrun.cost_serve_step(
            rwkv, mesh, ShapeConfig("card", SERVE_MESH_LEN, b, "decode"),
            fake=False, pos=pos_cost, ready=ready)
        torch.cuda.synchronize()
        peak_card = torch.cuda.max_memory_allocated(dev) - base
    finally:
        dist.destroy_process_group()
        if child is None:
            shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        _, err = child.communicate(timeout=600)
        check(child.returncode == 0, f"rwkv6_7b's decode step's fake run: "
              f"{err[-2000:]}")
        fk = json.loads((tmp / "fake.json").read_text())
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    peak_err = abs(fk["peak_bytes"] - peak_card) / peak_card
    flops_err = abs(fk["flops"] - card["flops"]) / card["flops"]
    log("mesh-serve-recurrent-cost", card=repr(smi), model=rwkv.name,
        layers=rwkv.n_layers, mesh="(1, 1)", batch=b, pos=pos_cost,
        peak_predicted=fk["peak_bytes"], held_predicted=fk["held_bytes"],
        peak_card=peak_card, peak_rel_err=peak_err,
        flops_predicted=fk["flops"], flops_card=card["flops"],
        flops_rel_err=flops_err, coll_bytes=fk["coll_bytes"],
        coll_bytes_card=card["coll_bytes"], regions=fk["regions"],
        fake_s=round(fk["seconds"], 3), card_s=round(card["seconds"], 3))
    check(peak_err <= PEAK_TOL, f"rwkv6_7b's decode step's predicted peak "
          f"{fk['peak_bytes']} against the card's {peak_card}")
    check(flops_err <= FLOPS_TOL, f"rwkv6_7b's decode step's flops "
          f"{fk['flops']} against the card's {card['flops']}")
    launches = {k: f.launches for k, f in all_kernels.items()}
    check(not any(launches.values()),
          f"the recurrent mesh serve phase launched a hand-written kernel: "
          f"{launches}")
    log("mesh-serve-recurrent-phase", card=repr(smi),
        seconds=round(time.perf_counter() - t_phase, 3))


def roofline_phase(dev, smi: str, all_kernels: dict, step_ms: list) -> None:
    """The dry run's cost half (phase 11i): ``roofline.op_cost`` over one
    rank's train step, as ``launch.dryrun`` costs every train cell.

    a. The card cell: 11h's step (llama3_2_1b, 4 × 512 tokens, 2
       microbatches, a one-rank mesh) costed on a fake 1 × 1 CPU mesh in a
       subprocess, replayed (the dry run's way) and unrolled, against the
       same step run for real on the card in a one-rank NCCL group under
       the same counter: the fake peak within ``PEAK_TOL`` of
       ``max_memory_allocated`` above what was held before the state was
       built, the fake flops within ``FLOPS_TOL`` of the card step's; the
       roofline time beside 11h's measured step ms (logged, no check).
    b. llama3_2_1b and moonshot ``train_4k`` on both production meshes
       (rank 0 of a fake group of 256 / 512 ranks, one subprocess a cell):
       flops a device, ``useful_ratio``, the dominant term, the peak and
       whether it fits this card.  A FAIL fails the script.

    The fake runs go on while the card runs its step.  No hand-written
    kernel may launch."""
    import concurrent.futures

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.roofline.analysis import model_flops_for, roofline

    t_phase = time.perf_counter()
    for fn in all_kernels.values():
        fn.launches = 0
    total = torch.cuda.get_device_properties(dev).total_memory
    cfg = get_config("llama3_2_1b")
    tmp = Path(tempfile.mkdtemp(prefix="roofline_", dir=ROOT / "build"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    children = {scaled: subprocess.Popen(
        [sys.executable, "-c", CARD_CELL_CHILD, cfg.name, str(TRAIN_BATCH),
         str(TRAIN_SEQ), str(cfg.microbatches), str(int(scaled)),
         str(tmp / f"card_{int(scaled)}.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for scaled in (True, False)}
    cells = [(arch, "train_4k", multi) for multi in (False, True)
             for arch in ROOFLINE_CELLS]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    swept = pool.submit(dryrun.run_cells, cells, force=True, verbose=False,
                        device_bytes=total, jobs=len(cells))
    try:
        # -- a. the card cell: the real step under the same counter ---------
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.set_device(dev.index or 0)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            t0 = time.perf_counter()
            card = dryrun.cost_train_step(
                cfg, make_host_mesh(1, 1, "cuda"), TRAIN_BATCH, TRAIN_SEQ,
                microbatches=cfg.microbatches, scaled=False, fake=False,
                seed=SEED)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            peak_card = torch.cuda.max_memory_allocated(dev) - base
            # what the process holds beyond its live tensors: the CUDA
            # context (and NCCL's and the libraries' own buffers) outside
            # the caching allocator, plus the allocator's reserve over the
            # allocated bytes at this cell's peak: the dry run's headroom
            free, whole = torch.cuda.mem_get_info(dev)
            outside = (whole - free) - torch.cuda.memory_reserved(dev)
            reserve = (torch.cuda.max_memory_reserved(dev)
                       - torch.cuda.max_memory_allocated(dev))
        finally:
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        fake = {}
        for scaled, p in children.items():
            _, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"the card cell's fake run: "
                  f"{err[-2000:]}")
            fake[scaled] = json.loads(
                (tmp / f"card_{int(scaled)}.json").read_text())
        shape = ShapeConfig("card", TRAIN_SEQ, TRAIN_BATCH, "train")
        params = dryrun.abstract_params(cfg)
        fk = fake[True]
        terms = roofline(fk["flops"], fk["dot_bytes"], fk["coll_bytes"],
                         chips=1, model_flops=model_flops_for(cfg, shape,
                                                              params),
                         coll_by_link=fk["coll_by_link"])
        peak_err = abs(fk["peak_bytes"] - peak_card) / peak_card
        flops_err = abs(fk["flops"] - card["flops"]) / card["flops"]
        log("roofline-card", card=repr(smi), model=cfg.name, mesh="(1, 1)",
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=cfg.microbatches,
            peak_predicted=fk["peak_bytes"],
            peak_predicted_unrolled=fake[False]["peak_bytes"],
            peak_card=peak_card, peak_rel_err=peak_err,
            flops_predicted=fk["flops"],
            flops_predicted_unrolled=fake[False]["flops"],
            flops_card=card["flops"], flops_rel_err=flops_err,
            peak_card_counter=card["peak_bytes"],
            coll_bytes=fk["coll_bytes"], coll_bytes_card=card["coll_bytes"],
            fake_s=round(fk["seconds"], 3),
            fake_unrolled_s=round(fake[False]["seconds"], 3),
            card_counted_step_s=round(card_s, 3),
            roofline_ms={k: terms.as_dict()[k] * 1e3 for k in
                         ("compute_s", "memory_s", "collective_s")},
            dominant=terms.dominant, useful_ratio=terms.useful_ratio,
            step_ms_measured_11h=step_ms)
        log("roofline-headroom", card=repr(smi), context_bytes=outside,
            reserve_over_allocated_bytes=reserve,
            headroom_bytes=outside + reserve,
            dryrun_headroom_bytes=dryrun.HEADROOM_BYTES,
            headroom_over_dryrun=(outside + reserve) / dryrun.HEADROOM_BYTES)
        check(peak_err <= PEAK_TOL, f"the card cell's predicted peak "
              f"{fk['peak_bytes']} against the card's {peak_card}")
        check(flops_err <= FLOPS_TOL, f"the card cell's flops "
              f"{fk['flops']} against the card step's {card['flops']}")
        del card

        # -- b. the production cells -----------------------------------------
        recs = swept.result(timeout=900)
    finally:
        pool.shutdown(wait=True)
        for p in children.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    for rec in recs:
        if rec["status"] != "OK":
            log("roofline-cell", card=repr(smi), arch=rec["arch"],
                mesh=rec["mesh"], status=rec["status"],
                error=rec.get("error", "")[:300])
            continue
        t = rec["roofline"]
        top = rec["collectives_top"][0] if rec["collectives_top"] else {}
        log("roofline-cell", card=repr(smi), arch=rec["arch"],
            shape=rec["shape"], mesh=rec["mesh"], chips=rec["chips"],
            flops_per_device=rec["flops_per_device"],
            bytes_per_device=rec["bytes_per_device"],
            coll_bytes=t["coll_bytes"], useful_ratio=t["useful_ratio"],
            dominant=t["dominant"], compute_ms=t["compute_s"] * 1e3,
            memory_ms=t["memory_s"] * 1e3,
            collective_ms=t["collective_s"] * 1e3,
            peak_bytes=rec["memory"]["peak_estimate_bytes"],
            card_bytes=rec["device_bytes"], fits_card=rec["fits"],
            top_collective=top.get("op"),
            top_collective_bytes=top.get("bytes"), cost_s=rec["cost_s"])
    bad = [(r["arch"], r["mesh"], r.get("error")) for r in recs
           if r["status"] != "OK"]
    check(not bad, f"roofline cells failed: {bad}")
    launches = {k: f.launches for k, f in all_kernels.items()}
    check(not any(launches.values()),
          f"the roofline phase launched a hand-written kernel: {launches}")
    log("roofline-phase", card=repr(smi),
        seconds=round(time.perf_counter() - t_phase, 3))


# phase 11l: sequence-parallel activations (``act_sharding="sp"``) at
# chameleon_34b's full width, cut to SP_LAYERS layers.  Its step's peak
# is the weights' (the fake count: 50.35 GB at one layer and one
# microbatch, whatever the tokens; 57.41 at two microbatches, 74.02 at
# two layers), beside the ~23 GB the earlier phases keep
SP_LAYERS = 1
SP_BATCH, SP_SEQ = 1, 4096     # one microbatch of 4,096 tokens
SP_CELL_CHILD = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
arch, layers, b, s, mb, out = sys.argv[1:7]
cfg = dataclasses.replace(get_config(arch), n_layers=int(layers))
dryrun.fake_group(1)
res = dryrun.cost_train_step(cfg, make_host_mesh(1, 1, "cpu"), int(b),
                             int(s), microbatches=int(mb), scaled=True)
with open(out, "w") as f:
    json.dump(res, f)
"""


def sp_phase(dev, smi: str, all_kernels: dict) -> None:
    """Sequence-parallel activations on the mesh (phase 11l), in its own
    one-rank NCCL group (an in-memory store), destroyed at its end:
    chameleon_34b at full width (d 8,192, 64 heads / 8 kv, qk-norm, d_ff
    22,016, vocab 65,536; fp32 weights from ``SEED``, bf16 compute) and
    ``SP_LAYERS`` layers, under ``act_sharding="sp"`` (its config's) and
    ``"dp"``.  A `model` of one rank splits nothing, so the two must
    agree bit for bit: the card shows that the sequence-parallel
    configuration runs the full-width path, and the gloo tests hold the
    split itself.

    a. The mesh prefill of ``SP_BATCH`` × ``SP_SEQ`` tokens on
       ``make_host_mesh(1, 1, "cuda")`` and ``serve_logits``: the two
       configurations' logits equal.
    b. One mesh train step of ``build_trainer(..., mesh=)`` on the same
       seed and batch (``cfg.microbatches`` slices): the losses, every
       gradient AdamW takes and every updated weight equal.
    c. That step costed by ``roofline.op_cost`` on a fake 1 × 1 CPU mesh
       in a subprocess (``SP_CELL_CHILD``, replayed) and on the card in
       the one-rank group (``dryrun.cost_train_step(..., fake=False)``):
       the flops equal, the fake peak within ``PEAK_TOL`` of
       ``max_memory_allocated`` above what was held before the state was
       built.

    No hand-written kernel may launch."""
    import dataclasses as dc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (make_host_mesh,
                                         production_mesh_shape)
    from repro_torch.launch.sharding import param_specs, seq_axes
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import (init_decode_state, init_model, prefill,
                                    shard_ctx)
    from repro_torch.models.transformer import serve_logits, tree_leaves
    from repro_torch.train import OptimizerConfig, adamw_update
    from repro_torch.train import train_step as TS

    t_phase = time.perf_counter()
    for fn in all_kernels.values():
        fn.launches = 0
    base_cfg = dc.replace(get_config("chameleon_34b"), n_layers=SP_LAYERS)
    check(base_cfg.act_sharding == "sp", "chameleon_34b's config is "
          "sequence-parallel")
    cfgs = {act: dc.replace(base_cfg, act_sharding=act)
            for act in ("sp", "dp")}
    opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    mb = base_cfg.microbatches
    tmp = Path(tempfile.mkdtemp(prefix="mesh_sp_", dir=ROOT / "build"))
    child = subprocess.Popen(
        [sys.executable, "-c", SP_CELL_CHILD, base_cfg.name,
         str(SP_LAYERS), str(SP_BATCH), str(SP_SEQ), str(mb),
         str(tmp / "fake.json")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    seen_seq = []
    set_ctx = shard_ctx.set_sharding_context

    def ctx_spy(*args, **kw):
        seen_seq.append(tuple(kw.get("seq", ())))
        return set_ctx(*args, **kw)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, "cuda")
        gen = torch.Generator(dev).manual_seed(SEED + 13)
        prompt = torch.randint(0, base_cfg.vocab_size, (SP_BATCH, SP_SEQ),
                               generator=gen, device=dev)
        # -- a. the mesh prefill under both configurations -----------------
        t0 = time.perf_counter()
        params = init_model(SEED, base_cfg, device=dev)
        specs = param_specs(params, mesh, base_cfg)
        logits, prefill_ms = {}, {}
        shard_ctx.set_sharding_context = ctx_spy
        try:
            for act, cfg in cfgs.items():
                state = init_decode_state(cfg, SP_BATCH, SP_SEQ,
                                          torch.bfloat16, device=dev)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                h, _ = prefill(params, {"tokens": prompt}, cfg, state,
                               mesh=mesh, specs=specs, skip_causal=True)
                out = serve_logits(params, h, cfg, mesh=mesh, specs=specs,
                                   global_batch=SP_BATCH)
                torch.cuda.synchronize()
                prefill_ms[act] = (time.perf_counter() - t1) * 1e3
                logits[act] = out.float().cpu()
                del state, h, out
        finally:
            shard_ctx.set_sharding_context = set_ctx
        same_logits = torch.equal(logits["sp"], logits["dp"])
        finite = bool(torch.isfinite(logits["sp"]).all())
        log("mesh-sp-prefill", card=repr(smi), model=base_cfg.name,
            layers=SP_LAYERS, d_model=base_cfg.d_model, mesh="(1, 1)",
            batch=SP_BATCH, prompt=SP_SEQ,
            logits_shape=list(logits["sp"].shape),
            bit_identical=same_logits, finite=finite,
            prefill_ms=prefill_ms,
            seq_axes_production=seq_axes(production_mesh_shape(),
                                         base_cfg, SP_SEQ),
            seq_axes_seen=sorted(set(seen_seq)),
            seconds=round(time.perf_counter() - t0, 3))
        check(finite and logits["sp"].shape == (
            SP_BATCH, 1, params["head"]["w_head"].shape[1]),
            f"the sp prefill's logits: {logits['sp'].shape}")
        check(same_logits, "the sp and dp prefill's logits bit for bit")
        del params, logits
        gc.collect()
        torch.cuda.empty_cache()

        # -- b. one mesh train step under both configurations --------------
        t0 = time.perf_counter()
        got = {}
        for act, cfg in cfgs.items():
            grads = []

            def spy(p, g, *args, _grads=grads, **kw):
                _grads.extend(t.detach().cpu() for t in tree_leaves(g))
                return adamw_update(p, g, *args, **kw)

            tr, st = build_trainer(cfg, opt_cfg, mesh=mesh, device=dev,
                                   global_batch=SP_BATCH, seq_len=SP_SEQ,
                                   ckpt_dir=tmp / act, seed=SEED)
            TS.adamw_update = spy
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st, met = tr.step_fn(st, tr.batch_fn(0))
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t1) * 1e3
            finally:
                TS.adamw_update = adamw_update
            got[act] = {"loss": float(met["loss"]), "grads": grads,
                        "step_ms": step_ms,
                        "params": [t.to_local().cpu() for t in
                                   tree_leaves(st.params)]}
            del tr, st, met
            gc.collect()
            torch.cuda.empty_cache()
        sp_run, dp_run = got["sp"], got["dp"]
        same_grads = len(sp_run["grads"]) == len(dp_run["grads"]) and all(
            torch.equal(a, b) for a, b in zip(sp_run["grads"],
                                              dp_run["grads"]))
        same_params = all(torch.equal(a, b) for a, b in
                          zip(sp_run["params"], dp_run["params"]))
        log("mesh-sp-train", card=repr(smi), model=base_cfg.name,
            layers=SP_LAYERS, mesh="(1, 1)", batch=SP_BATCH, seq=SP_SEQ,
            microbatches=mb, loss_sp=sp_run["loss"], loss_dp=dp_run["loss"],
            grads_bit_identical=same_grads, grad_leaves=len(sp_run["grads"]),
            weights_bit_identical=same_params,
            step_ms_sp=sp_run["step_ms"], step_ms_dp=dp_run["step_ms"],
            seconds=round(time.perf_counter() - t0, 3))
        check(sp_run["loss"] == dp_run["loss"] and
              math.isfinite(sp_run["loss"]),
              f"the sp and dp steps' losses: {sp_run['loss']} "
              f"{dp_run['loss']}")
        check(same_grads, "the sp and dp steps' gradients bit for bit")
        check(same_params, "the sp and dp steps' weights bit for bit")
        del got, sp_run, dp_run
        gc.collect()
        torch.cuda.empty_cache()

        # -- c. the sp step costed on the card and on a fake rank ----------
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        card = dryrun.cost_train_step(cfgs["sp"], mesh, SP_BATCH, SP_SEQ,
                                      microbatches=mb, scaled=False,
                                      fake=False, seed=SEED)
        torch.cuda.synchronize()
        peak_card = torch.cuda.max_memory_allocated(dev) - base
    finally:
        shard_ctx.set_sharding_context = set_ctx
        TS.adamw_update = adamw_update
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    try:
        _, err = child.communicate(timeout=600)
        check(child.returncode == 0, f"the sp step's fake run: "
              f"{err[-2000:]}")
        fk = json.loads((tmp / "fake.json").read_text())
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    peak_err = abs(fk["peak_bytes"] - peak_card) / peak_card
    log("mesh-sp-cost", card=repr(smi), model=base_cfg.name,
        layers=SP_LAYERS, mesh="(1, 1)", batch=SP_BATCH, seq=SP_SEQ,
        microbatches=mb, peak_predicted=fk["peak_bytes"],
        peak_card=peak_card, peak_rel_err=peak_err,
        flops_predicted=fk["flops"], flops_card=card["flops"],
        coll_bytes=fk["coll_bytes"], coll_bytes_card=card["coll_bytes"],
        fake_s=round(fk["seconds"], 3), card_s=round(card["seconds"], 3))
    check(fk["flops"] == card["flops"], f"the sp step's flops "
          f"{fk['flops']} against the card's {card['flops']}")
    check(peak_err <= PEAK_TOL, f"the sp step's predicted peak "
          f"{fk['peak_bytes']} against the card's {peak_card}")
    launches = {k: f.launches for k, f in all_kernels.items()}
    check(not any(launches.values()),
          f"the sequence-parallel phase launched a hand-written kernel: "
          f"{launches}")
    log("mesh-sp-phase", card=repr(smi),
        seconds=round(time.perf_counter() - t_phase, 3))


# phase 11m: host-clock repetitions of each timed bind and backward, and
# of the host paths they replace (~1-5 s each)
AUTODIFF_REPS = 5
HOST_PATH_REPS = 3


@contextlib.contextmanager
def refused(*targets):
    """Make each ``(owner, name)`` attribute raise while the block runs:
    what a device-side path must never call."""
    saved = [(o, n, getattr(o, n)) for o, n in targets]

    def refuse(*args, **kwargs):
        raise AssertionError("a device-side bind took the host path")
    try:
        for o, n, _ in saved:
            setattr(o, n, refuse)
        yield
    finally:
        for o, n, f in saved:
            setattr(o, n, f)


def host_seconds(fn, reps: int = AUTODIFF_REPS) -> list:
    """Host-clock seconds of ``fn`` (a sync on each side), ``reps`` times."""
    import torch

    out = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def autodiff_phase(dev, m, smi: str, op, x, all_kernels: dict, plans: list,
                   healthy) -> dict:
    """The transform-safe operator (phase 11m) on elasticity3d(64), with no
    new build: the k = 1 ``ehyb_packed`` plan (132 × 5,984) and, in its own
    one-rank NCCL group, the sharded plan on its partition and host build
    (11e's).  Counts from 0, then on the local plan: the value and x
    gradients of ``wᵀ A(v) x`` through ``p.bind(v)``, the double backward
    ``∇_v uᵀ ∇ₓ(wᵀ A(v) x)`` and ``torch.func.vmap`` over 16 right-hand
    sides (#8 once); on the sharded plan: a tensor bind's three value
    tables against the host bind's, bit for bit in fp32 and bf16, with
    ``EHYB.refill``, ``matrix_key``, ``Tensor.cpu`` and ``Tensor.numpy``
    made to raise around it, and the value and x gradients in both spaces
    and the double backward.  Each gradient is held against a float64
    index-op oracle on the card (1e-4 of the largest).  Then it times a
    sharded tensor bind on the device against the host path it replaced
    (the values copied to the host, hashed, refilled and uploaded), one
    sharded x-backward against the parent's (the values uploaded again,
    bound through the host, applied: replayed step by step), and
    ``vmap(16)`` against a loop of 16 applies.  Returns the main path's
    launches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.api import ExecutionConfig, plan
    from repro_torch.core import counters
    from repro_torch.core.ehyb import EHYB
    from repro_torch.core.matrices import SparseCSR
    from repro_torch.dist.operator import EHYBShards

    plan_mod = importlib.import_module("repro_torch.api.plan")
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    p = op.plan
    gen = torch.Generator(dev).manual_seed(SEED + 30)
    w, u = (torch.randn(m.n, generator=gen, device=dev) for _ in range(2))
    X = torch.randn(K_RHS, m.n, generator=gen, device=dev)
    rows, cols = p.coo_tensors()
    v32 = torch.as_tensor(m.data, dtype=f32, device=dev)
    # float64 oracles of the fp32 tables' values
    x64, w64, u64 = x.double(), w.double(), u.double()
    gv_ref = w64[rows] * x64[cols]
    gx_ref = torch.zeros(m.n, dtype=f64, device=dev).index_add_(
        0, cols, v32.double() * w64[rows])
    gg_ref = w64[rows] * u64[cols]
    errs = {}

    def drel(a, b) -> float:
        """max|a − b| / max|b|, in float64 on the card."""
        b = b.double()
        return float((a.double() - b).abs().max()
                     / b.abs().max().clamp_min(1e-12))

    def grads(pl, tag):
        """The value and x gradients and the double backward through a
        bind on ``pl``."""
        vals = v32.clone().requires_grad_(True)
        xg = x.clone().requires_grad_(True)
        ((pl.bind(vals) @ xg) @ w).backward()
        errs[tag + "_gv"] = drel(vals.grad, gv_ref)
        errs[tag + "_gx"] = drel(xg.grad, gx_ref)
        vals.grad = None
        xg = x.clone().requires_grad_(True)
        gx, = torch.autograd.grad((pl.bind(vals) @ xg) @ w, xg,
                                  create_graph=True)
        gg, = torch.autograd.grad(gx @ u, vals)
        errs[tag + "_double"] = drel(gg, gg_ref)
        return vals

    torch.cuda.synchronize()
    for fn in all_kernels.values():
        fn.launches = 0
    # -- the local plan: gradients, double backward, vmap over 16 rhs -------
    grads(p, "local")
    n8 = all_kernels["ehyb_packed_fused_spmm"].launches
    n2 = all_kernels["ehyb_packed_fused"].launches
    Y = torch.func.vmap(lambda xx: op @ xx)(X)
    torch.cuda.synchronize()
    vmap_8 = all_kernels["ehyb_packed_fused_spmm"].launches - n8
    vmap_2 = all_kernels["ehyb_packed_fused"].launches - n2
    # -- the sharded plan, one rank ----------------------------------------
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        t0 = time.perf_counter()
        pd = plan(m, mesh=mesh, execution=ExecutionConfig(
            format="ehyb_packed", partition_method="bfs"))
        opd = pd.bind(m)
        torch.cuda.synchronize()
        t_plan_bind = time.perf_counter() - t0
        plans.append(pd)
        check(pd.partition is p.partition and pd.transpose is pd,
              "the sharded plan shares the k = 1 plan's partition; the "
              "pattern is its own transpose")
        refill0 = counters.snapshot().get("ehyb_refill", 0)
        same, n_idx = {}, {}
        for dt in (f32, torch.bfloat16):
            host = pd.bind(m, dtype=dt)
            t0 = time.perf_counter()
            with refused((EHYB, "refill"), (plan_mod, "matrix_key"),
                         (torch.Tensor, "cpu"), (torch.Tensor, "numpy")):
                dev_op = pd.bind(v32, dtype=dt)
                torch.cuda.synchronize()
            n_idx[str(dt)] = time.perf_counter() - t0
            same[str(dt)] = all(
                getattr(dev_op.obj, f).dtype == getattr(host.obj, f).dtype
                and torch.equal(getattr(dev_op.obj, f), getattr(host.obj, f))
                for f in EHYBShards.VALUE_FIELDS)
        refills = counters.snapshot().get("ehyb_refill", 0) - refill0
        vals = grads(pd, "sharded")
        vals.grad = None
        opv = pd.bind(vals)
        x_loc = opv.to_space(x).requires_grad_(True)
        (opv.apply(x_loc, space="permuted") * opv.to_space(w)).sum(
            ).backward()
        errs["sharded_perm_gx"] = drel(opv.from_space(x_loc.grad),
                                                 gx_ref)
        errs["sharded_perm_gv"] = drel(vals.grad, gv_ref)
        pad_zero = not bool(x_loc.grad[opv.obj.local_perm >= m.n].any())
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in all_kernels.items()}
        log("autodiff-main-path", launches=launches, vmap16_launches_8=vmap_8,
            vmap16_launches_2=vmap_2, plan_and_bind_s=round(t_plan_bind, 3),
            first_tensor_bind_s={k: round(v, 4) for k, v in n_idx.items()},
            tables_bit_identical=same, host_refills=refills,
            pad_zero=pad_zero, **errs)
        check(all(v <= 1e-4 for v in errs.values()),
              f"the gradients agree with the float64 oracle: {errs}")
        check(vmap_8 == 1 and vmap_2 == 0,
              f"vmap over 16 rhs launched #8 once: {vmap_8}, #2 {vmap_2}")
        check(all(same.values()) and refills == 0,
              f"a sharded tensor bind equals the host bind, bit for bit, "
              f"with no host refill: {same}, {refills}")
        check(pad_zero, "the padding slots of x's shard get zero")
        path = ("ehyb_packed_fused", "ehyb_packed_fused_spmm", "ehyb_ell",
                "er")
        check(all(launches[k] > 0 for k in path)
              and all(launches[k] == 0 for k in launches if k not in path),
              f"the autodiff path went through #2, #8, #4 and #6 only: "
              f"{launches}")
        errs_v = {"vmap16_vs_batched": drel(Y, (op @ X.T).T)}
        check(errs_v["vmap16_vs_batched"] <= 1e-4, f"vmap: {errs_v}")
        # -- times ---------------------------------------------------------
        dvec = 1.0 + 0.25 * np.random.default_rng(SEED + 31).random(m.n)
        row_of_m = np.repeat(np.arange(m.n), m.row_lengths())
        scaled = [torch.as_tensor(m.data * dvec[row_of_m] * dvec[m.indices]
                                  * s, dtype=f32, device=dev)
                  for s in (1.0, 2.0)]
        bind_dev = host_seconds(lambda i: pd.bind(scaled[i % 2]))
        # the parent's tensor path: to the host, hashed, refilled, uploaded
        bind_host = host_seconds(lambda i: pd._bind_sharded(
            scaled[i % 2].detach().cpu().double().numpy(), f32, True),
            HOST_PATH_REPS)
        op_h = pd.bind(m)
        t_ord = pd.transpose_order_tensor()

        def backward_now(i):
            xg = x.clone().requires_grad_(True)
            y = (op_h @ xg) @ w
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y.backward()
            torch.cuda.synchronize()
            bw_now.append(time.perf_counter() - t0)

        def backward_parent(i):
            # ``_DiffApply.backward`` at the parent: the values uploaded
            # from the host matrix (``values_of``), bound through the host
            # (``_bind_sharded`` of the tensor), Aᵀ w applied
            t_vals = torch.from_numpy(np.ascontiguousarray(m.data)).to(
                dev, f32).index_select(0, t_ord)
            t_obj = pd.transpose._bind_sharded(
                t_vals.detach().cpu().double().numpy(), f32, False).obj
            pd.transpose._raw_apply()(t_obj, w[:, None])

        bw_now: list = []
        host_seconds(backward_now)
        bw_parent = host_seconds(backward_parent, HOST_PATH_REPS)
        t_vmap = time_ms(lambda: torch.func.vmap(lambda xx: op @ xx)(X), dev)
        t_loop = time_ms(lambda: [op @ X[i] for i in range(K_RHS)], dev)
        h_vmap = host_seconds(lambda i: torch.func.vmap(
            lambda xx: op @ xx)(X))
        h_loop = host_seconds(lambda i: [op @ X[i] for i in range(K_RHS)])
        med = statistics.median
        log("autodiff-times", card=repr(smi),
            sharded_tensor_bind_device_s=med(bind_dev),
            sharded_tensor_bind_host_s=med(bind_host),
            bind_device_all=[round(v, 4) for v in bind_dev],
            bind_host_all=[round(v, 4) for v in bind_host],
            sharded_backward_s=med(bw_now),
            sharded_backward_parent_path_s=med(bw_parent),
            backward_all=[round(v, 4) for v in bw_now],
            backward_parent_all=[round(v, 4) for v in bw_parent],
            vmap16_ms=t_vmap, loop16_ms=t_loop,
            vmap16_host_s=med(h_vmap), loop16_host_s=med(h_loop), **errs_v)
        healthy("autodiff")
        del opd, op_h, opv, vals, dev_op, host, scaled, pd, mesh
    finally:
        dist.destroy_process_group()
    log("autodiff-phase", seconds=round(time.perf_counter() - t_phase, 3))
    return {k: launches[k] for k in path}


# one process of ``--mesh-step-ab``: argv is (src dir, out file)
MESH_STEP_CHILD = r"""
import json, statistics, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import build_trainer
from repro_torch.train import OptimizerConfig

batch, seq, steps = 4, 512, 6
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                        world_size=1)
cfg = get_config("llama3_2_1b")
opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=100)
out = {"src": sys.argv[1]}
ckpt = tempfile.TemporaryDirectory()
for name, mesh in (("plain", None), ("mesh", make_host_mesh(1, 1, "cuda"))):
    tr, st = build_trainer(cfg, opt_cfg, mesh=mesh, device=dev,
                           global_batch=batch, seq_len=seq,
                           ckpt_dir=f"{ckpt.name}/{name}", seed=0)
    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, met = tr.step_fn(st, tr.batch_fn(i))
        float(met["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    out[name + "_ms"] = ms
    out[name + "_median_ms"] = statistics.median(ms[1:])
    del tr, st
    torch.cuda.empty_cache()
dist.destroy_process_group()
ckpt.cleanup()
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


# one process of ``--serve-decode-ab``: argv is (src dir, out file); 11f's
# 4-slot engine serves its 12 requests once (the head's kernel is built
# then), then SERVE_AB_ROUNDS times timed; then the unsharded trunk's
# decode_step alone, 4 rows at the engine's depth, no head
SERVE_AB_ROUNDS, TRUNK_STEPS = 3, 40
SERVE_DECODE_CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_decode_state, init_model
from repro_torch.serve import Request, ServeEngine

kw, n_req, new, seed, rounds, n_trunk = json.loads(sys.argv[3])
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
cfg = get_config("llama3_2_1b")
params = init_model(torch.Generator(dev).manual_seed(seed), cfg)
eng = ServeEngine(params, cfg, batch=4, device=dev, **kw)
rng = np.random.default_rng(seed)
lens = rng.integers(4, kw["max_prompt"] + 1, n_req)
prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
           for n in lens]
uid = [0]


def serve():
    for p in prompts:
        eng.submit(Request(uid=uid[0], prompt=p, max_new_tokens=new))
        uid[0] += 1
    return eng.run_until_done()


serve()
step_s = {"prefill": [], "decode": []}
real = eng._guarded_call


def timed(which, *args):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = real(which, *args)
    torch.cuda.synchronize()
    step_s[which].append(time.perf_counter() - t)
    return out


eng._guarded_call = timed
for _ in range(rounds):
    serve()
del eng._guarded_call, eng
state = init_decode_state(cfg, 4, kw["max_len"], torch.bfloat16, device=dev)
tok = torch.zeros((4, 1), dtype=torch.int64, device=dev)
trunk = []
with torch.no_grad():
    for i in range(n_trunk):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, state = decode_step(params, tok, cfg, state, kw["max_prompt"] + i)
        torch.cuda.synchronize()
        trunk.append(time.perf_counter() - t)
out = {"src": sys.argv[1],
       "engine_decode_ms": [1e3 * x for x in step_s["decode"]],
       "engine_prefill_ms": [1e3 * x for x in step_s["prefill"]],
       "trunk_decode_ms": [1e3 * x for x in trunk]}
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


def ab_runs(child: str, other_src: str, rounds: int, *args) -> tuple:
    """``child`` (argv: src dir, out file, ``args``) from ``other_src``
    and from this checkout, other · this · this · other a round, each in
    a fresh process: (other's src dir, every run's JSON)."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        order = [str(Path(other_src).resolve()), str(ROOT / "src")]
        srcs = [order[0], order[1], order[1], order[0]] * rounds
        for i, src in enumerate(srcs):
            out = Path(tmp) / f"run{i}.json"
            subprocess.run([sys.executable, "-c", child, src, str(out),
                            *args], check=True, timeout=600)
            runs.append(json.loads(out.read_text()))
    return order[0], runs


def serve_decode_ab(other_src: str, smi: str, rounds: int = 1) -> None:
    """``--serve-decode-ab``: 11f's engine decode and the unsharded
    trunk's decode step timed from ``other_src`` and from this checkout
    (:func:`ab_runs`)."""
    other, runs = ab_runs(SERVE_DECODE_CHILD, other_src, rounds, json.dumps(
        [SERVE_KW, SERVE_REQUESTS, SERVE_NEW, SEED, SERVE_AB_ROUNDS,
         TRUNK_STEPS]))
    for i, r in enumerate(runs):
        log("serve-decode-ab", card=repr(smi), run=i,
            tree="other" if r["src"] == other else "this",
            engine_decode_steps=len(r["engine_decode_ms"]),
            engine_decode_median_ms=statistics.median(r["engine_decode_ms"]),
            engine_prefill_median_ms=statistics.median(
                r["engine_prefill_ms"]),
            trunk_decode_median_ms=statistics.median(
                r["trunk_decode_ms"][1:]),
            trunk_decode_ms=[round(x, 2) for x in r["trunk_decode_ms"]])


def mesh_step_ab(other_src: str, smi: str, rounds: int = 1) -> None:
    """``--mesh-step-ab``: 11h's steps timed from ``other_src`` and from
    this checkout (:func:`ab_runs`)."""
    order0, runs = ab_runs(MESH_STEP_CHILD, other_src, rounds)
    for i, r in enumerate(runs):
        log("mesh-step-ab", card=repr(smi), run=i,
            tree="other" if r["src"] == order0 else "this",
            plain_ms=[round(x, 1) for x in r["plain_ms"]],
            mesh_ms=[round(x, 1) for x in r["mesh_ms"]],
            plain_median_ms=round(r["plain_median_ms"], 1),
            mesh_median_ms=round(r["mesh_median_ms"], 1))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    ab = {"--mesh-step-ab": mesh_step_ab,
          "--serve-decode-ab": serve_decode_ab}.get(
              sys.argv[1] if len(sys.argv) > 1 else None)
    if ab is not None:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(smi, flush=True)
        ab(sys.argv[2], smi, int(sys.argv[3]) if len(sys.argv) > 3 else 1)
        return 0
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

    from repro_torch import tuning
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

    # ---- 2b. the default plan: partition and format autotuned, its cold
    # decisions saved into a tune store in a fresh directory ----------------
    (ROOT / "build").mkdir(exist_ok=True)
    store_dir = Path(tempfile.mkdtemp(prefix="tune_store_",
                                      dir=ROOT / "build"))
    tuning.set_store(store_dir)
    m_default = elasticity3d(NX_DEFAULT)
    log("default-plan-matrix", nx=NX_DEFAULT, n=m_default.n,
        nnz=m_default.nnz)
    cold = default_plan_phase(dev, m_default, plans, all_kernels, healthy)

    # ---- 2c. the same plans served by the store (a main path) --------------
    warm_default = store_phase(dev, m_default, cold, plans, all_kernels,
                               healthy)

    # ---- 2d. a calibration fitted on the card, and the plan it ranks -------
    calibration_phase(dev, m_default, m, plans, healthy)
    tuning.set_store(None)
    shutil.rmtree(store_dir)

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

    # ---- 5d. the full verifier on the main plans; seeded corruptions -------
    verify_phase(m, {"k1": (p_packed, m), "k16": (pb, m),
                     "default": (warm_default, m_default)}, op, all_kernels)
    del warm_default, m_default

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
    log("solve-trace", warm_wall_ms=warm["fused"] * 1e3,
        traced_wall_ms=t_traced * 1e3, device_busy_ms=busy_ms,
        idle_share=(1 - busy_ms / (warm["fused"] * 1e3)) if busy_ms else
        "not measured",
        top_device_us=top_device_us(dev_us, 6),
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

    # ---- 11e. the distributed path (a main path): a one-rank NCCL group ---
    launches_d = dist_phase(dev, m, smi, op, {
        "x": x, "x_host": x_host, "xb": xb, "xb_host": xb_host, "b": b,
        "b_host": b_host, "a_sp": a_sp, "res": res}, plans, all_kernels,
        healthy)

    # ---- 11f. the serving path (a main path): llama3_2_1b at full width ---
    launches_s = serve_phase(dev, smi, plans, all_kernels, healthy)

    # ---- 11g. the train path (a main path): llama3_2_1b at full width, the
    # resume and failure runs, value training on #8, the new architectures
    launches_g, max_abs_g = train_phase(dev, smi, plans, all_kernels,
                                        healthy)

    # ---- 11h. the mesh path: the sharded train step, the distributed MoE,
    # a restore onto the mesh and the dry run, in a one-rank NCCL group
    step_ms_mesh = mesh_phase(dev, smi, all_kernels)
    healthy("mesh")

    # ---- 11i. the dry run's cost half: the card cell's predicted peak and
    # flops against the card's step, and four production cells
    roofline_phase(dev, smi, all_kernels, step_ms_mesh)
    healthy("roofline")

    # ---- 11j. the mesh prefill and decode: llama3_2_1b at full width on a
    # one-rank mesh against the unsharded path, and its decode step costed
    mesh_serve_phase(dev, smi, all_kernels)
    healthy("mesh-serve")

    # ---- 11k. the recurrent families on the mesh: rwkv6_7b at full width
    # and one Mamba block at jamba's, against the unsharded path, and
    # rwkv6_7b's decode step costed
    recurrent_mesh_serve_phase(dev, smi, all_kernels)
    healthy("mesh-serve-recurrent")

    # ---- 11l. sequence-parallel activations: chameleon_34b at full width,
    # the mesh prefill and train step under "sp" and "dp", and the step
    # costed
    sp_phase(dev, smi, all_kernels)
    healthy("mesh-sp")

    # ---- 11m. the transform-safe operator: gradients through a bind, local
    # and sharded, double backward, torch.func.vmap over 16 rhs
    launches_m = autodiff_phase(dev, m, smi, op, x, all_kernels, plans,
                                healthy)

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
    for k, n in launches_d.items():        # the sharded path's launches
        launches[k] += n
    for k, n in launches_s.items():        # the serving path's launches
        launches[k] += n
    for k, n in launches_g.items():        # the train path's launches
        launches[k] += n
    for k, n in launches_m.items():        # the autodiff path's launches
        launches[k] += n
    max_abs.update({k: v[1] for k, v in rel_chk.items()})
    for k, e in max_abs_g.items():         # #8 at the value step's K = 64
        max_abs[k] = max(max_abs[k], e)
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

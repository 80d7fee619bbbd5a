"""One rank of a multi-rank ``repro_torch.dist`` check on the CPU (gloo).

    python tests/torch_dist_worker.py SCENARIO RANK WORLD STORE OUT

Joins a gloo group of WORLD ranks through a ``FileStore`` at STORE (no
port to collide on), builds ``init_device_mesh("cpu", (WORLD,),
mesh_dim_names=("data",))``, runs SCENARIO and, on rank 0, writes its
numbers as JSON to OUT.  Imports torch, numpy and ``repro_torch`` only —
never jax.  ``tests/test_torch_dist.py`` spawns WORLD of these and holds
the numbers to the reference's bounds.
"""

from __future__ import annotations

import hashlib
import json
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, dtype=np.float64)
                        - np.asarray(b, dtype=np.float64)).max())


def _same_on_ranks(t: torch.Tensor, group) -> bool:
    """Whether ``t`` holds the same bits on every rank of ``group``."""
    h = hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()
    got = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, h, group=group)
    return len(set(got)) == 1


def _matrix(name: str):
    from repro_torch.core.matrices import poisson3d, powerlaw

    return {"poisson": lambda: poisson3d(12),
            "powerlaw": lambda: powerlaw(2048, 6),
            "poisson10": lambda: poisson3d(10)}[name]()


def sweep(mesh, res: dict, names=("poisson", "powerlaw")) -> None:
    """The reference's equivalence sweep (``tests/test_dist.py``), held
    against the CSR product and the port's local apply: applies in both
    spaces, K = 3, the refill, CG and BiCGStab against the local solve,
    fp64, promotion, padding and the shim."""
    from repro_torch.api import ExecutionConfig, plan
    from repro_torch.core import counters
    from repro_torch.core.dist_spmv import build_dist_spmv
    from repro_torch.core.ehyb import build_ehyb
    from repro_torch.core.matrices import SparseCSR
    from repro_torch.dist.operator import _build_sharded_operator

    group = mesh.get_group("data")
    rng = np.random.default_rng(0)
    for name in names:
        m = _matrix(name)
        p = plan(m, mesh=mesh, execution=ExecutionConfig(format="ehyb"))
        op = p.bind(m)
        op_l = plan(m, execution=ExecutionConfig(
            format="ehyb", partition_method=p.partition_strategy),
            device="cpu").bind(m)
        x = rng.standard_normal(m.n)
        X = rng.standard_normal((m.n, 3))
        y = op @ x
        res[name + "/format"] = p.format
        res[name + "/context"] = p.context
        res[name + "/strategy"] = p.partition_strategy
        res[name + "/orig"] = _err(y, op_l @ x)
        y_csr = m.spmv(x)
        res[name + "/orig_csr"] = _err(y, y_csr) / np.abs(y_csr).max()
        res[name + "/replicated"] = _same_on_ranks(y, group)
        res[name + "/batched"] = _err(op @ X, op_l @ X)
        xn = op.to_space(x)
        res[name + "/shard_rows"] = int(xn.shape[0])
        res[name + "/permuted"] = _err(
            op.from_space(op.apply(xn, space="permuted")), op_l @ x)
        xi = torch.arange(m.n, dtype=torch.int32)
        yi = op @ xi
        res[name + "/int_dtype"] = str(yi.dtype)
        res[name + "/int"] = _err(yi, op_l @ xi) / _err(op_l @ xi, 0)
        # refill: pattern fixed, values pushed, zero structure passes
        m2 = SparseCSR(m.n, m.indptr, m.indices, m.data * 1.5)
        counters.reset()
        op2 = op.update_values(m2)
        snap = counters.snapshot()
        res[name + "/refill_structural"] = sum(
            snap.get(k, 0) for k in ("partition", "build_ehyb",
                                     "build_halo_plan", "group_er",
                                     "pack_staircase", "build_buckets",
                                     "shard_operator"))
        res[name + "/refill_shared"] = bool(
            op2.obj.ell_cols is op.obj.ell_cols
            and op2.obj.fer_cols is op.obj.fer_cols
            and op2.obj.send_pos is op.obj.send_pos)
        res[name + "/refill_err"] = _err(op2 @ x, 1.5 * (op_l @ x))
        fresh = plan(m2, mesh=mesh, execution=ExecutionConfig(
            format="ehyb", partition_method=p.partition_strategy),
            cache=type(p.cache)()).bind(m2)
        res[name + "/refill_vs_fresh"] = _err(op2 @ x, fresh @ x)
        # the distributed solve against the local one
        b = rng.standard_normal(m.n)
        r0 = op_l.solve(b, precond="jacobi", max_iters=250, warn=False)
        r1 = op.solve(b, precond="jacobi", max_iters=250, warn=False)
        res[name + "/solve_x_err"] = _err(r0.x, r1.x)
        res[name + "/solve_res"] = [float(r0.residual), float(r1.residual)]
        res[name + "/solve_iters"] = [int(r0.iters), int(r1.iters)]
        res[name + "/solve_status"] = r1.status
        res[name + "/solve_true_res"] = float(
            np.linalg.norm(m.spmv(r1.x.double().numpy()) - b)
            / np.linalg.norm(b))
        if name == "poisson":       # bicgstab breaks down on powerlaw
            rb = op_l.solve(b, method="bicgstab", precond="jacobi",
                            max_iters=250, warn=False)
            rb1 = op.solve(b, method="bicgstab", precond="jacobi",
                           max_iters=250, warn=False)
            res[name + "/bicg_x_err"] = _err(rb.x, rb1.x)
            res[name + "/bicg_res"] = [float(rb.residual),
                                       float(rb1.residual)]
        hp = op.halo_plan
        if op_l.obj.n_parts % hp.n_dev == 0:
            from repro_torch.dist import build_allgather_spmv

            ag = build_allgather_spmv(op_l.obj, mesh, "data")
            res[name + "/allgather_err"] = _err(ag(torch.as_tensor(
                x, dtype=torch.float32)), op_l @ x)
        res[name + "/halo_words"] = hp.halo_words
        res[name + "/allgather_words"] = hp.allgather_words
        res[name + "/has_push"] = bool(hp.has_push)
        try:
            op.solve(b, fused_update=True)
            res[name + "/fused_refused"] = False
        except ValueError:
            res[name + "/fused_refused"] = True
    # fp64
    m = _matrix("poisson10")
    op = plan(m, mesh=mesh, execution=ExecutionConfig(format="ehyb")).bind(
        m, dtype=torch.float64)
    x = rng.standard_normal(m.n)
    y = op @ x
    res["fp64/dtype"] = str(y.dtype)
    res["fp64/err"] = _err(y, m.spmv(x))
    # partition padding: n_parts = 6 over the mesh
    e = build_ehyb(m, n_parts=6, vec_size=-(-m.n // 6 // 8) * 8)
    sop = _build_sharded_operator(e, mesh, "data")
    res["pad/parts"] = [sop.plan.n_parts_pad, sop.plan.parts_per_dev]
    res["pad/err"] = _err(sop(x), m.spmv(x))
    # the deprecated shim over a bound local operator
    op_l = plan(m, execution=ExecutionConfig(format="ehyb",
                                             partition_method="bfs"),
                device="cpu").bind(m)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mv = build_dist_spmv(op_l, mesh, "data")
    res["shim/warned"] = any(issubclass(w.category, DeprecationWarning)
                             for w in caught)
    res["shim/err"] = _err(mv(torch.as_tensor(x, dtype=torch.float32)),
                           op_l @ x)


def layer(mesh, res: dict) -> None:
    """``pruned_linear(mesh=)`` against the local layer: forward, and the
    gradients of a loss with respect to the input and the values."""
    from repro_torch.api import pruned_linear

    rng = np.random.default_rng(3)
    w = rng.standard_normal((48, 64))
    lay_d = pruned_linear(w, 0.2, format="ehyb", partition_method="bfs",
                          mesh=mesh)
    lay_l = pruned_linear(w, 0.2, format="ehyb", partition_method="bfs",
                          device="cpu")
    xs = []
    for lay in (lay_d, lay_l):
        x = torch.as_tensor(rng.standard_normal((5, 64)) if not xs
                            else xs[0].detach().numpy(),
                            dtype=torch.float32).requires_grad_(True)
        xs.append(x)
        lay(x).square().sum().backward()
    res["layer/fwd"] = _err(lay_d(xs[0]).detach(), lay_l(xs[1]).detach())
    res["layer/grad_x"] = _err(xs[0].grad, xs[1].grad)
    res["layer/grad_values"] = _err(lay_d.values.grad, lay_l.values.grad)
    res["layer/sharded"] = lay_d.op.plan.is_sharded


def decisions(mesh, res: dict) -> None:
    """The default plan's decisions on a few SUITE matrices (the parent
    holds them against the reference's plan on a mesh of this size)."""
    from repro_torch.api import plan
    from repro_torch.core.matrices import SUITE

    for name in ("poisson3d_16", "elasticity_8", "powerlaw_4k"):
        p = plan(SUITE[name](), mesh=mesh)
        res[f"{name}/format"] = p.format
        res[f"{name}/strategy"] = p.partition_strategy
        res[f"{name}/context"] = p.context
        res[f"{name}/modeled"] = dict(p.tuning.modeled_bytes)
        res[f"{name}/part_modeled"] = dict(p.partition_tuning.modeled_bytes)


def store(mesh, res: dict) -> None:
    """A mesh plan with a tune store: saved under a key ending in
    ``-d{n_dev}``, then served to a fresh ``PlanCache`` with no
    partitioning and no tuning (each rank its own store directory)."""
    import os

    from repro_torch import tuning
    from repro_torch.api import PlanCache, plan
    from repro_torch.core import counters
    from repro_torch.core.matrices import SUITE

    rank = dist.get_rank()
    tuning.set_store(os.path.join(STORE_ROOT, f"rank{rank}"))
    try:
        m = SUITE["elasticity_8"]()
        cold = plan(m, mesh=mesh, cache=PlanCache())
        keys = sorted(os.listdir(os.path.join(STORE_ROOT, f"rank{rank}")))
        counters.reset()
        warm = plan(m, mesh=mesh, cache=PlanCache())
        snap = counters.snapshot()
        res["store/keys"] = keys
        res["store/hit"] = snap.get("tune_store.hit", 0)
        res["store/partition"] = snap.get("partition", 0)
        res["store/same"] = warm.identity() == cold.identity()
        res["store/n_dev"] = warm.n_dev
    finally:
        tuning.set_store(None)


def bare(mesh, res: dict) -> None:
    """``core.dist_spmv.build_dist_spmv`` on a bare ``EHYBDevice`` (the
    legacy shim's path, ``dist.operator.ehyb_from_device``): the product
    of poisson3d(12) built with 8 partitions, in fp32, on a seeded x;
    its pseudo host build's refill refused (no fill plan)."""
    from repro_torch.core.dist_spmv import build_dist_spmv
    from repro_torch.core.ehyb import build_ehyb
    from repro_torch.core.matrices import poisson3d
    from repro_torch.core.spmv import EHYBDevice
    from repro_torch.dist.operator import _build_sharded_operator

    m = poisson3d(12)
    e = build_ehyb(m, n_parts=8, vec_size=-(-m.n // 8 // 8) * 8)
    dev = EHYBDevice.from_ehyb(e, device="cpu")
    x = np.random.default_rng(0).standard_normal(m.n).astype(np.float32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mv = build_dist_spmv(dev, mesh, "data")
    res["bare/warned"] = any(issubclass(w.category, DeprecationWarning)
                             for w in caught)
    y = mv(torch.from_numpy(x))
    res["bare/dtype"] = str(y.dtype)
    res["bare/y"] = y.double().tolist()
    op = _build_sharded_operator(dev, mesh, "data")
    res["bare/nnz"] = [op.nnz, op.host_ehyb.nnz_in]
    try:
        op.update_values(m)
        res["bare/refill_refused"] = False
    except ValueError:
        res["bare/refill_refused"] = True


def _vec(m, seed: int) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(m.n),
                           dtype=torch.float32)


def _coo(m):
    return np.repeat(np.arange(m.n), m.row_lengths()), m.indices


def _rel(a, b) -> float:
    b = np.asarray(b, dtype=np.float64)
    return _err(a, b) / max(float(np.abs(b).max()), 1e-12)


def _tables(obj) -> list:
    from repro_torch.dist.operator import EHYBShards

    return [getattr(obj, f) for f in EHYBShards.VALUE_FIELDS]


def autodiff(mesh, res: dict) -> None:
    """Gradients through the sharded operator on poisson3d(8) and
    powerlaw(512, 6), pinned ``ehyb`` and ``ehyb_packed`` on bfs partitions,
    fp32, against float64 formulas (the parent holds them, and the value
    gradient against the reference's one-device mesh): the value gradient
    through ``p.bind(v)``; the permuted-space gradients, the padding slots
    zero; the double backward ``∇_v uᵀ ∇ₓ(wᵀ A(v) x) = w[rows]·u[cols]``; a
    tensor bind's tables against the host bind's, bit for bit (fp32, bf16),
    with ``EHYB.refill`` and ``matrix_key`` patched to raise around it;
    ``update_values(tensor)`` on the operator and on its engine; and a bare
    ``EHYBDevice`` shard refusing a tensor."""
    import importlib

    from repro_torch.api import ExecutionConfig, PlanCache, plan
    from repro_torch.core.ehyb import EHYB
    from repro_torch.core.matrices import poisson3d, powerlaw

    plan_mod = importlib.import_module("repro_torch.api.plan")
    group = mesh.get_group("data")
    for name, m in (("poisson", poisson3d(8)),
                    ("powerlaw", powerlaw(512, 6))):
        rows, cols = _coo(m)
        d = m.to_dense()
        x, w, u = _vec(m, 1), _vec(m, 2), _vec(m, 3)
        xh, wh, uh = (t.double().numpy() for t in (x, w, u))
        for fmt in ("ehyb", "ehyb_packed"):
            key = f"{name}/{fmt}/"
            p = plan(m, mesh=mesh, cache=PlanCache(), execution=
                     ExecutionConfig(format=fmt, partition_method="bfs"))
            # the value gradient through p.bind(v), and x's
            vals = torch.tensor(m.data, dtype=torch.float32,
                                requires_grad=True)
            xg = x.clone().requires_grad_(True)
            ((p.bind(vals) @ xg) * w).sum().backward()
            res[key + "gv"] = _rel(vals.grad, wh[rows] * xh[cols])
            res[key + "gv_values"] = vals.grad.double().tolist()
            res[key + "gx"] = _rel(xg.grad, d.T @ wh)
            res[key + "grad_same_on_ranks"] = _same_on_ranks(vals.grad,
                                                             group)
            # the permuted space: the rank's shard in and out
            vals.grad = None
            op = p.bind(vals)
            x_loc = op.to_space(x).requires_grad_(True)
            y_loc = op.apply(x_loc, space="permuted")
            (y_loc * op.to_space(w)).sum().backward()
            res[key + "perm_gx"] = _rel(op.from_space(x_loc.grad),
                                        d.T @ wh)
            live = op.obj.local_perm < m.n
            res[key + "perm_pad_zero"] = not bool(x_loc.grad[~live].any())
            res[key + "perm_gv"] = _rel(vals.grad, wh[rows] * xh[cols])
            # double backward
            vals.grad = None
            xg = x.clone().requires_grad_(True)
            gx, = torch.autograd.grad((p.bind(vals) @ xg) @ w, xg,
                                      create_graph=True)
            gv2, = torch.autograd.grad(gx @ u, vals)
            res[key + "double"] = _rel(gv2, wh[rows] * uh[cols])
            # a tensor bind's tables are the host bind's, bit for bit, and
            # it does no host work
            same = True
            for dt in (torch.float32, torch.bfloat16):
                host = p.bind(m, dtype=dt)
                refill, mkey = EHYB.refill, plan_mod.matrix_key

                def refuse(*a, **k):
                    raise AssertionError("host work in a tensor bind")
                EHYB.refill = plan_mod.matrix_key = refuse
                try:
                    dev = p.bind(torch.as_tensor(m.data,
                                                 dtype=torch.float32),
                                 dtype=dt)
                    y_dev = dev @ x
                    vg = torch.tensor(m.data, dtype=torch.float32,
                                      requires_grad=True)
                    ((p.bind(vg, dtype=dt) @ x.clone().requires_grad_(
                        True)) @ w).backward()
                finally:
                    EHYB.refill, plan_mod.matrix_key = refill, mkey
                same &= all(a.dtype == b.dtype and torch.equal(a, b)
                            for a, b in zip(_tables(dev.obj),
                                            _tables(host.obj)))
                same &= torch.equal(y_dev, host @ x)
            got = [None] * dist.get_world_size(group)
            dist.all_gather_object(got, bool(same), group=group)
            res[key + "tables_bit_identical"] = all(got)
            # update_values(tensor): the operator's and its engine's
            op = p.bind(m)
            t2 = torch.as_tensor(1.5 * m.data, dtype=torch.float32)
            res[key + "update_op"] = _rel(op.update_values(t2) @ x,
                                          1.5 * (d @ xh))
            eng = p._engine(op)
            e2 = eng.update_values(t2)
            res[key + "update_engine_shared"] = bool(
                e2.obj.ell_cols is eng.obj.ell_cols)
            res[key + "update_engine"] = _rel(e2(x), 1.5 * (d @ xh))
            res[key + "values_of"] = _rel(p.values_of(op.obj), m.data)
    # a bare EHYBDevice shard has no fill plan: a tensor refill raises
    from repro_torch.core.ehyb import build_ehyb
    from repro_torch.core.spmv import EHYBDevice
    from repro_torch.dist.operator import _build_sharded_operator

    m = poisson3d(8)
    e = build_ehyb(m, n_parts=4, vec_size=-(-m.n // 4 // 8) * 8)
    sop = _build_sharded_operator(EHYBDevice.from_ehyb(e, device="cpu"),
                                  mesh, "data")
    try:
        sop.update_values(torch.as_tensor(m.data, dtype=torch.float32))
        res["bare/tensor_refused"] = False
    except ValueError:
        res["bare/tensor_refused"] = True


STORE_ROOT = ""
SCENARIOS = {"sweep": sweep, "layer": layer, "decisions": decisions,
             "store": store, "bare": bare, "autodiff": autodiff}


def main() -> int:
    global STORE_ROOT
    scenario, rank, world, store_path, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    STORE_ROOT = store_path + ".tune"
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    res: dict = {"world": world}
    try:
        for name in scenario.split(","):
            SCENARIOS[name](mesh, res)
        res["jax_loaded"] = any(k == "jax" or k.startswith("jax.")
                                for k in sys.modules)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

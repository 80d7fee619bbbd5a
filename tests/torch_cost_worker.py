"""One process of the cost counter's checks (``roofline.op_cost``) on the
CPU.

    python tests/torch_cost_worker.py SCENARIO OUT [RANK WORLD STORE]

Without RANK it is rank 0 of a ``fake`` process group (no communication)
of the scenario's size; with them it joins a gloo group of WORLD ranks
through a ``FileStore`` at STORE.  Writes its numbers as JSON to OUT (rank
0).  Imports torch, numpy and ``repro_torch`` only — never jax.
``tests/test_torch_roofline.py`` and ``tests/test_torch_dryrun_cost.py``
run it and hold the numbers to fixed answers, to torch's
``FlopCounterMode`` and to each other.

Scenarios (fake group): ``collective`` (4 ranks), ``archs[:A,B]`` (the
architectures at smoke size on 2 × 2: unrolled beside
``FlopCounterMode``, then scaled), ``calls`` (llama3_2_1b and moonshot on
2 × 2, the collectives in order), ``flops:D,M:A,B[:KINDS[:DEPTH]]``
(rank 0's flops on a (D, M) mesh: the train step, or the prefill and
decode steps), ``group_fake`` (the (data, model) group made under
``FakeTensorMode``), ``cell:ARCH:single|multi[:LAYERS[:MB]]`` (a
production ``train_4k`` cell at full width, replayed and unrolled; at
full depth the unrolled run of a scan architecture takes hours); gloo:
``calls``
(4 ranks, real tensors), ``group_gloo`` (8 ranks), ``cap`` (2 ranks).
"""

from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist

BATCH, SEQ = 4, 8           # the smoke step: 2 rows a rank on 2 × 2
MESH22 = {"data": 2, "model": 2}
MATMULS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")


def mesh_of(shape: dict):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def short_chunks() -> None:
    """Scan and loss chunks of a few steps, so that an 8-token smoke step
    runs each chunk loop several times (the repeats under test)."""
    from repro_torch.models import layers, mamba, rwkv

    mamba._ssm_scan.__defaults__ = (2,)
    rwkv._wkv_scan.__defaults__ = (2,)
    layers.chunked_xent.__defaults__ = (4,)


def step_cost(arch, mesh, *, scaled, fake=True, flop_counter=False,
              batch=BATCH, seq=SEQ):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = get_config(arch, smoke=True)
    if not flop_counter:
        return dryrun.cost_train_step(cfg, mesh, batch, seq, scaled=scaled,
                                      fake=fake)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        res = dryrun.cost_train_step(cfg, mesh, batch, seq, scaled=scaled,
                                     fake=fake)
    got = fc.get_flop_counts()["Global"]
    res["flop_counter"] = float(sum(v for k, v in got.items()
                                    if str(k) in MATMULS))
    return res


def _keep(res) -> dict:
    keys = ("flops", "bytes", "dot_bytes", "coll_bytes", "coll_by_op",
            "coll_by_axis", "coll_by_link", "peak_bytes", "held_bytes",
            "n_ops", "regions", "flop_counter", "coll_calls", "seconds")
    return {k: res[k] for k in keys if k in res}


def collective(res) -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline.op_cost import OpCost

    mesh = mesh_of(MESH22)
    with FakeTensorMode():
        x = torch.ones(16, 16)
        for name, group in (("world", None),
                            ("data", mesh.get_group("data"))):
            cost = OpCost(mesh)
            with cost:
                dist.all_reduce(x, group=group)
            res[name] = cost.result()


def archs(res, arch_ids=None) -> None:
    from repro_torch.configs import ARCH_IDS

    short_chunks()
    mesh = mesh_of(MESH22)
    for arch in arch_ids or ARCH_IDS:
        res[arch] = {
            "unrolled": _keep(step_cost(arch, mesh, scaled=False,
                                        flop_counter=True)),
            "scaled": _keep(step_cost(arch, mesh, scaled=True))}


def calls(res) -> None:
    mesh = mesh_of(MESH22)
    for arch in ("llama3_2_1b", "moonshot_v1_16b_a3b"):
        r = step_cost(arch, mesh, scaled=False,
                      fake=not dist.get_backend() == "gloo")
        res[arch] = {"coll_calls": r["coll_calls"],
                     "coll_by_op": r["coll_by_op"],
                     "coll_by_axis": r["coll_by_axis"],
                     "flops": r["flops"]}


def flops(res, data: int, model: int, arch_ids, kinds=("train",),
          depth: int = 32) -> None:
    """Rank 0's flops on a (data, model) mesh at smoke size, 32 tokens a
    row: the train step on a batch of 4 rows a microbatch (each
    microbatch splits over the data ranks, as the reference's step shards
    it), keyed by architecture; the mesh prefill of 4 rows and the decode
    step of 4 rows against a ``depth``-deep cache (the prefill: of
    ``depth`` tokens), keyed ``kind/arch``; each with its collectives."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    mesh = mesh_of({"data": data, "model": model})
    for kind in kinds:
        for arch in arch_ids:
            cfg = get_config(arch, smoke=True)
            if kind == "train":
                b = 4 * cfg.microbatches
                r = step_cost(arch, mesh, scaled=True, batch=b, seq=32)
                res[arch] = {"flops": r["flops"], "batch": b,
                             "coll_bytes": r["coll_bytes"],
                             "coll_by_op": r["coll_by_op"]}
                continue
            r = dryrun.cost_serve_step(cfg, mesh,
                                       ShapeConfig("t", depth, 4, kind))
            res[f"{kind}/{arch}"] = {"flops": r["flops"], "batch": 4,
                                     "coll_bytes": r["coll_bytes"],
                                     "coll_by_op": r["coll_by_op"]}


def _axis_group_ranks(mesh, axes=("data", "model")):
    from repro_torch.models import shard_ctx

    g = shard_ctx.axis_group(mesh, axes)
    return dist.get_process_group_ranks(g)


def group_fake(res) -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = mesh_of(MESH22)
    with FakeTensorMode():               # as the MoE's token split makes it
        res["ranks"] = _axis_group_ranks(mesh)


def group_gloo(res) -> None:
    """On (pod, data, model) = (2, 2, 2): each multi-axis group's ranks,
    and the row holding this rank in the rank table as the port built it
    before (tensor ops on ``mesh.mesh``)."""
    import math

    mesh = mesh_of({"pod": 2, "data": 2, "model": 2})
    names = mesh.mesh_dim_names
    for axes in (("data", "model"), ("pod", "data"), ("pod", "model")):
        dims = [names.index(a) for a in axes]
        ranks = mesh.mesh
        rest = [i for i in range(ranks.ndim) if i not in dims]
        rows = ranks.permute(*rest, *dims).reshape(
            -1, math.prod(ranks.shape[d] for d in dims)).tolist()
        mine = [r for r in rows if dist.get_rank() in r][0]
        res[",".join(axes)] = {"group": _axis_group_ranks(mesh, axes),
                               "tensor_row": mine}


def cap(res) -> None:
    """llama3_2_1b at smoke size on (data=2, model=1), 2 rows a rank and
    8 microbatches asked for (so one row each, ``rank_microbatches``),
    against the unsharded step's 2 microbatches on the whole batch: the
    same gradient mean, so the same loss and weights."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import distribute_state, gather_state
    from repro_torch.models import init_model
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   make_train_step)

    cfg = dataclasses.replace(get_config("llama3_2_1b", smoke=True),
                              dtype="float32")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (4, 17))
    batch = {"tokens": torch.as_tensor(tok[:, :-1], dtype=torch.int32),
             "labels": torch.as_tensor(tok[:, 1:], dtype=torch.int32),
             "mask": torch.ones(4, 16)}
    mesh = mesh_of({"data": 2, "model": 1})
    state = distribute_state(init_train_state(
        init_model(0, cfg, device="cpu"), cfg), mesh, cfg)
    step = make_train_step(cfg, opt, microbatches=8, mesh=mesh)
    state, met = step(state, batch)
    full = gather_state(state)
    plain = init_train_state(init_model(0, cfg, device="cpu"), cfg)
    plain, pmet = make_train_step(cfg, opt, microbatches=2)(plain, batch)
    res["loss"] = [float(met["loss"]), float(pmet["loss"])]
    res["weights"] = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(full.params), tree_leaves(plain.params)))


def cell(res, arch: str, multi: bool, layers: int = 0,
         microbatches: int = 0) -> None:
    """One production ``train_4k`` cell at full width (``layers``,
    ``microbatches``: cut to that, 0 keeps the config's), replayed and
    unrolled: the dry run's cost, and the check that its replay is exact
    at full width."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES["train_4k"]
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    mb = microbatches or cfg.microbatches
    res.update(arch=arch, mesh=dryrun.MESHES[multi], n_layers=cfg.n_layers,
               microbatches=mb)
    for scaled in (True, False):
        r = dryrun.cost_train_step(cfg, mesh, shape.global_batch,
                                   shape.seq_len, microbatches=mb,
                                   scaled=scaled)
        res["scaled" if scaled else "unrolled"] = {
            k: r[k] for k in ("flops", "bytes", "dot_bytes", "coll_bytes",
                              "coll_by_op", "peak_bytes", "seconds")}


SCENARIOS = {"collective": (collective, 4), "archs": (archs, 4),
             "calls": (calls, 4), "group_fake": (group_fake, 4),
             "group_gloo": (group_gloo, 8), "cap": (cap, 2)}


def scenario_of(name: str):
    """``(fn, world)``; ``flops:D,M:ARCH[,ARCH...][:KIND[,KIND...][:DEPTH]]``
    is :func:`flops` on a (D, M) mesh, ``archs:ARCH[,ARCH...]`` :func:`archs` over those,
    ``cell:ARCH:single|multi[:LAYERS[:MICROBATCHES]]`` :func:`cell` on
    that production mesh (rank 0 of a fake group of 256 or 512 ranks)."""
    head, _, rest = name.partition(":")
    if head == "flops":
        dims, _, ids = rest.partition(":")
        ids, _, kinds = ids.partition(":")
        kinds, _, depth = kinds.partition(":")
        d, m = (int(x) for x in dims.split(","))
        kinds = tuple(kinds.split(",")) if kinds else ("train",)
        return (lambda res: flops(res, d, m, ids.split(","), kinds,
                                  int(depth or 32))), d * m
    if head == "archs" and rest:
        return (lambda res: archs(res, rest.split(","))), 4
    if head == "cell":
        arch, mesh, *cuts = rest.split(":")
        multi = mesh == "multi"
        return ((lambda res: cell(res, arch, multi, *map(int, cuts))),
                512 if multi else 256)
    return SCENARIOS[name]


def main() -> int:
    scenario, out = sys.argv[1:3]
    fn, world = scenario_of(scenario)
    torch.set_num_threads(1)
    rank = 0
    if len(sys.argv) > 3:
        rank, world, store = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
    else:
        from repro_torch.launch.dryrun import fake_group

        fake_group(world)
    res: dict = {}
    try:
        fn(res)
        res["jax_loaded"] = any(k == "jax" or k.startswith("jax.")
                                for k in sys.modules)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One rank of a multi-rank check of the port's mesh layer on the CPU (gloo).

    python tests/torch_mesh_worker.py SCENARIOS RANK WORLD STORE OUT IN

Joins a gloo group of WORLD ranks through a ``FileStore`` at STORE, runs
each comma-joined scenario on the meshes it builds over that group, and,
on rank 0, writes the numbers as JSON to OUT.  IN is a directory of
inputs the test wrote with the JAX package (weights, the reference's
outputs, a reference-written checkpoint).  Imports torch, numpy and
``repro_torch`` only — never jax.  ``tests/test_torch_mesh.py`` spawns
WORLD of these and holds the numbers to the reference's.

Scenarios: ``shards`` (8 ranks), ``step_llama`` (8), ``moe`` (8),
``step_moonshot`` (4), ``norm`` (4), ``restore`` (4), ``cli`` (4).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from collections import namedtuple

import numpy as np
import torch
import torch.distributed as dist

SEP = "//"
IN = ""


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def load_tree(path) -> dict:
    """A nested dict of numpy arrays from an ``.npz`` keyed by path."""
    out: dict = {}
    with np.load(path) as z:
        for k in z.files:
            node = out
            *head, last = k.split(SEP)
            for h in head:
                node = node.setdefault(h, {})
            node[last] = z[k]
    return out


def mesh_of(shape: dict):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def gather_to_rank0(obj):
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def _names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _names(v, f"{prefix}{k}{SEP}")
        else:
            yield prefix + k, v


def ported_state(name: str, cfg):
    """The reference's initial TrainState (its params from IN) carried by
    ``convert.train_state``, on the CPU."""
    from repro_torch import convert
    from repro_torch.models.transformer import tree_map

    from repro_torch.models import init_model

    loaded = load_tree(os.path.join(IN, f"{name}_params.npz"))

    def fill(tmpl, got):             # keeps the empty dicts (a tied head)
        if isinstance(tmpl, dict):
            return {k: fill(v, got.get(k, {})) for k, v in tmpl.items()}
        return got

    params = fill(init_model(0, cfg, device="cpu"), loaded)
    zeros = tree_map(np.zeros_like, params)
    opt = namedtuple("Opt", "m v step")(zeros, zeros, np.int32(0))
    st = namedtuple("State", "params opt step")(params, opt, np.int32(0))
    return convert.train_state(st, cfg, device="cpu")


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def shards(res: dict) -> None:
    """Each rank's block of every param and moment leaf (fsdp on) on
    (pod, data, model) = (2, 2, 2) and (data, model) = (2, 4): its start
    and stop in every dim, read off an arange-valued full leaf."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import distribute_state
    from repro_torch.models import init_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.train import init_train_state

    meshes = {"pdm": {"pod": 2, "data": 2, "model": 2},
              "dm": {"data": 2, "model": 4}}
    for arch in ("llama3_2_1b", "moonshot_v1_16b_a3b",
                 "jamba_1_5_large_398b"):
        cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=True)
        full = tree_map(lambda t: torch.arange(t.numel(), dtype=torch.float64
                                               ).reshape(t.shape),
                        init_model(0, cfg, device="cpu"))
        st = init_train_state(full, cfg)
        st = st._replace(opt=st.opt._replace(
            m=tree_map(torch.clone, full), v=tree_map(torch.clone, full)))
        for mname, shape in meshes.items():
            mesh = mesh_of(shape)
            d = distribute_state(st, mesh, cfg)
            mine = {"coord": list(mesh.get_coordinate())}
            for tree_name, tree in (("params", d.params), ("m", d.opt.m),
                                    ("v", d.opt.v)):
                for key, leaf in _names(tree):
                    loc = leaf.to_local()
                    shp = tuple(leaf.shape)
                    v0 = int(loc.flatten()[0]) if loc.numel() else 0
                    strides = torch.empty(shp).stride()
                    starts = [(v0 // s) % n for s, n in zip(strides, shp)]
                    block = full_leaf = leaf.full_tensor()
                    for dim, (a, n) in enumerate(zip(starts, loc.shape)):
                        block = block.narrow(dim, a, n)
                    mine[f"{tree_name}{SEP}{key}"] = {
                        "block": [[a, a + n] for a, n in
                                  zip(starts, loc.shape)],
                        "same": bool(torch.equal(block, loc)),
                        "full": bool(torch.equal(
                            full_leaf, torch.arange(
                                full_leaf.numel(),
                                dtype=torch.float64).reshape(shp)))}
            res[f"shards/{arch}/{mname}"] = gather_to_rank0(mine)


def _step_case(res: dict, tag: str, arch: str, mesh_shape: dict,
               **replace) -> None:
    """Two mesh steps from the reference's initial state against two
    single-process steps of the port: losses, grad norms, and the
    gathered weights' largest difference."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch.sharding import distribute_state, gather_state
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import OptimizerConfig, make_train_step

    cfg = get_config(arch, smoke=True)
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
    mesh = mesh_of(mesh_shape)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    s0 = ported_state(arch, cfg)
    s1 = distribute_state(ported_state(arch, cfg), mesh, cfg)
    step0 = make_train_step(cfg, opt)
    step1 = make_train_step(cfg, opt, mesh=mesh, donate=True)
    ds = SyntheticTokenDataset(cfg.vocab_size, 32, 4, seed=5)
    rows = []
    for i in range(2):
        b = {k: torch.from_numpy(v) for k, v in ds.train_inputs(i).items()}
        s0, m0 = step0(s0, b)
        s1, m1 = step1(s1, b)
        rows.append({k: [float(m0[k]), float(m1[k])]
                     for k in ("loss", "grad_norm", "nll", "moe_aux")})
    g = gather_state(s1)
    res[f"{tag}/metrics"] = rows
    res[f"{tag}/weights"] = max(_err(a, b) for a, b in zip(
        tree_leaves(s0.params), tree_leaves(g.params)))
    res[f"{tag}/steps"] = [int(g.step), int(g.opt.step)]


def step_llama(res: dict) -> None:
    _step_case(res, "step_llama", "llama3_2_1b", {"data": 2, "model": 4})


def step_moonshot(res: dict) -> None:
    # capacity 8: no token is dropped, so the per-shard capacity of the
    # MoE's distributed path cannot differ from the single-device step's
    _step_case(res, "step_moonshot", "moonshot_v1_16b_a3b",
               {"data": 2, "model": 2}, fsdp=True, capacity_factor=8.0)


def moe(res: dict) -> None:
    """The distributed MoE on (data, model) = (2, 4) against the port's
    local path (capacity 8: outputs, aux, the input's gradient and every
    weight's gradient summed over the ranks that split the tokens) and against the reference's
    ``_apply_moe_dist`` (default capacity, with drops; grok's ffn mode)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models import shard_ctx

    mesh = mesh_of({"data": 2, "model": 4})
    ref = np.load(os.path.join(IN, "moe.npz"))
    try:
        for arch, tag in (("moonshot_v1_16b_a3b", "moonshot"),
                          ("grok_1_314b", "grok")):
            base = get_config(arch, smoke=True)
            p = {k: torch.from_numpy(ref[f"{tag}_{k}"])
                 for k in ("router", "we_gate", "we_up", "we_down")}
            x = torch.from_numpy(ref[f"{tag}_x"])
            shard_ctx.set_sharding_context(mesh, ("data",))
            split = M.moe_split(x.shape[0] * x.shape[1], mesh, ("data",),
                                base)
            res[f"moe/{tag}/split"] = [list(split[0]), split[1], split[2]]
            y, aux = M.apply_moe(p, x, base)
            res[f"moe/{tag}/vs_ref"] = _err(y, torch.from_numpy(
                ref[f"{tag}_y"]))
            res[f"moe/{tag}/aux_vs_ref"] = abs(float(aux)
                                               - float(ref[f"{tag}_aux"]))
            cfg = dataclasses.replace(base, capacity_factor=8.0)
            c = torch.from_numpy(np.random.default_rng(3).standard_normal(
                x.shape).astype(np.float32))
            outs = []
            for dist_path in (True, False):
                if not dist_path:
                    shard_ctx.clear_sharding_context()
                pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
                xx = x.clone().requires_grad_(True)
                y, aux = M.apply_moe(pp, xx, cfg)
                ((y * c).sum() + aux).backward()
                grads = {k: v.grad for k, v in pp.items()}
                if dist_path:   # each rank's tokens' share: sum the split
                    grads = {k: shard_ctx.reduce_sum(g, mesh, split[0])
                             for k, g in grads.items()}
                outs.append((y.detach(), aux.detach(), xx.grad, grads))
            (y1, a1, gx1, g1), (y0, a0, gx0, g0) = outs
            res[f"moe/{tag}/vs_local"] = _err(y1, y0)
            res[f"moe/{tag}/aux_vs_local"] = abs(float(a1) - float(a0))
            res[f"moe/{tag}/xgrad_vs_local"] = _err(gx1, gx0) / float(
                gx0.abs().max())
            res[f"moe/{tag}/wgrad_vs_local"] = max(
                _err(g1[k], g0[k]) / float(g0[k].abs().max()) for k in g0)
    finally:
        shard_ctx.clear_sharding_context()


def norm(res: dict) -> None:
    """``global_norm`` and ``clip_by_global_norm`` of a ``DTensor`` tree
    on (2, 2) — a replicated leaf, leaves sharded over `data`, over
    `model` and over both — against the same full tree's: every element
    counted once, and each rank's clipped shards the blocks of the full
    tree's clipped leaves."""
    from repro_torch.launch.sharding import local_block, shard_leaf
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train import clip_by_global_norm, global_norm

    mesh = mesh_of({"data": 2, "model": 2})
    gen = torch.Generator().manual_seed(4)
    full = {"rep": torch.randn(6, generator=gen),
            "data": torch.randn(8, 3, generator=gen),
            "model": torch.randn(2, 4, generator=gen),
            "both": {"w": torch.randn(4, 6, generator=gen)}}
    specs = {"rep": (None,), "data": ("data", None), "model": (None, "model"),
             "both": {"w": ("data", "model")}}
    sharded = tree_map(lambda t, sp: shard_leaf(t, sp, mesh), full, specs)
    want = float(global_norm(full))
    res["norm/rel"] = abs(float(global_norm(sharded)) - want) / want
    clipped, _ = clip_by_global_norm(sharded, 1.0)
    ref, _ = clip_by_global_norm(full, 1.0)
    blocks = tree_map(lambda t, sp: local_block(t, sp, mesh), ref, specs)
    res["norm/clipped_blocks"] = max(_err(a, b) for a, b in zip(
        tree_leaves(clipped), tree_leaves(blocks)))


def restore(res: dict) -> None:
    """Save a sharded state on (2, 2); restore it onto (4, 1), onto one
    process with no mesh, and a reference-written checkpoint onto (2, 2):
    every leaf bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch.sharding import distribute_state, gather_state
    from repro_torch.models import init_model
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import (CheckpointManager, OptimizerConfig,
                                   init_train_state, make_train_step)

    cfg = dataclasses.replace(get_config("moonshot_v1_16b_a3b", smoke=True),
                              fsdp=True, opt_state_dtype="bfloat16")
    a, b = mesh_of({"data": 2, "model": 2}), mesh_of({"data": 4, "model": 1})
    st = distribute_state(init_train_state(init_model(0, cfg, device="cpu"),
                                           cfg), a, cfg)
    batch = SyntheticTokenDataset(cfg.vocab_size, 32, 4,
                                  seed=5).train_inputs(0)
    st, _ = make_train_step(cfg, OptimizerConfig(), mesh=a)(st, batch)
    ckpt = CheckpointManager(os.path.join(IN, "mesh_ckpt"))
    ckpt.save(1, st)

    def leaves(state):
        return [*tree_leaves(state.params), *tree_leaves(state.opt.m),
                *tree_leaves(state.opt.v), state.opt.step, state.step]

    want = leaves(gather_state(st))
    tmpl = init_train_state(init_model(1, cfg, device="cpu"), cfg)
    on_b = ckpt.restore(1, distribute_state(tmpl, b, cfg))
    res["restore/onto_4x1"] = all(torch.equal(x, y) for x, y in zip(
        leaves(gather_state(on_b)), want))
    res["restore/placed_4x1"] = str(on_b.params["embed"]["embedding"]
                                    .placements)
    plain = ckpt.restore(1, tmpl)
    res["restore/no_mesh"] = all(torch.equal(x, y) for x, y in
                                 zip(leaves(plain), want))
    res["restore/dtype"] = str(plain.opt.m["embed"]["embedding"].dtype)
    # a checkpoint the reference wrote (llama3_2_1b smoke after one step)
    lcfg = get_config("llama3_2_1b", smoke=True)
    ref = CheckpointManager(os.path.join(IN, "ref_ckpt"))
    tmpl = distribute_state(init_train_state(
        init_model(1, lcfg, device="cpu"), lcfg), a, lcfg)
    got = gather_state(ref.restore(ref.latest_step(), tmpl))
    with np.load(os.path.join(IN, "ref_ckpt",
                              f"step_{ref.latest_step():010d}.npz")) as z:
        stored = {k: z[k] for k in z.files}
    from repro_torch.train.checkpoint import _flatten

    res["restore/reference"] = all(
        np.array_equal(v, stored[k]) for k, v in _flatten(got).items()) \
        and _flatten(got).keys() == stored.keys()


def cli(res: dict) -> None:
    from repro_torch.launch import train as cli_mod

    hist = cli_mod.main(["--arch", "llama3_2_1b", "--smoke", "--steps", "3",
                         "--global-batch", "4", "--seq-len", "32",
                         "--data-par", "2", "--model-par", "2",
                         "--device", "cpu", "--ckpt-dir",
                         os.path.join(IN, "cli_ckpt")])
    res["cli/loss"] = [h["loss"] for h in hist]
    res["cli/grad_norm"] = [h["grad_norm"] for h in hist]


SCENARIOS = {"shards": shards, "step_llama": step_llama, "moe": moe,
             "step_moonshot": step_moonshot, "norm": norm,
             "restore": restore, "cli": cli}


def main() -> int:
    global IN
    scenario, rank, world, store_path, out, IN = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    res: dict = {"world": world}
    try:
        for name in scenario.split(","):
            SCENARIOS[name](res)
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

"""One rank of the mesh prefill and decode check on the CPU (gloo).

    python tests/torch_mesh_serve_worker.py RANK WORLD STORE IN OUT

Joins a gloo group of WORLD ranks through a ``FileStore`` at STORE and,
for every case of IN/cases.json (an architecture at smoke size, its
config replaced by the case's ``replace``, on a mesh over those ranks),
runs the port's single-process ``prefill`` and four ``decode_step``s (the
second at per-row positions) and the same steps on the mesh
(``prefill(..., mesh=)``, ``decode_step(..., mesh=)``, ``serve_logits``)
from this rank's shards of the same weights and state — laid out by
``state_specs(..., context_parallel=True)`` for a case that asks for it,
its caches' sequence split over `data`.  Rank 0 writes every step's
logits (the mesh's with the vocab gathered here, and the single
process's) to OUT/logits.npz and the numbers to OUT/result.json.  The
weights are the JAX package's, read from IN as ``.npz`` files (one for
each case's ``model``); this process imports torch, numpy and
``repro_torch`` only — never jax.  ``tests/test_torch_mesh_serve.py``
spawns WORLD of these and holds the logits to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

SEP = "//"
DECODE_STEPS = 4


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


def smoke_config(arch: str, replace=None):
    """The smoke config the test gives both packages: MoE at capacity
    factor 8 (with drops, the distributed MoE's per-shard capacity drops
    other tokens than one device's, by design), and ``replace``'s
    fields."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return dataclasses.replace(cfg, **(replace or {}))


def first_block(state, key):
    """The first unit block of ``state`` that holds ``key``, or None."""
    return next((k for k, v in state.items() if key in v), None)


def run_case(case: dict, inputs: dict, in_dir: str) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.launch.sharding import (local_block, param_specs,
                                             state_specs)
    from repro_torch.models import decode_step, init_decode_state, prefill
    from repro_torch.models.transformer import (mesh_params, serve_logits,
                                                tree_leaves, tree_map)

    arch, shape = case["arch"], case["mesh"]
    cfg = smoke_config(arch, case.get("replace"))
    cp = bool(case.get("context_parallel"))
    mesh = init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))
    tree = load_tree(os.path.join(in_dir, f"{case['model']}_params.npz"))
    tree.setdefault("head", {})          # a tied head: an empty dict
    params = convert.lm_params(tree, cfg, device="cpu")
    b, s = inputs["tokens"].shape
    batch = {"tokens": torch.as_tensor(inputs["tokens"])}
    enc = 0
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.as_tensor(inputs["enc_frames"])
        enc = s
    max_len = int(inputs["max_len"])
    steps = [(torch.as_tensor(inputs[f"step{i}_tokens"]),
              torch.as_tensor(inputs[f"step{i}_pos"]))
             for i in range(DECODE_STEPS)]
    st0 = init_decode_state(cfg, b, max_len, torch.float32, enc_len=enc,
                            device="cpu")

    # the single process, state kept after every step
    single_logits, single_states = [], []
    h, st = prefill(params, batch, cfg, st0)
    single_logits.append(serve_logits(params, h, cfg))
    single_states.append(st)
    for tok, pos in steps:
        h, st = decode_step(params, tok, cfg, st,
                            pos if pos.ndim else int(pos))
        single_logits.append(serve_logits(params, h, cfg))
        single_states.append(st)
    untouched = all(not t.any() for t in tree_leaves(st0))

    # the mesh: this rank's shards of the same weights and state
    p_specs = param_specs(params, mesh, cfg)
    s_specs = state_specs(st0, mesh, cfg, global_batch=b,
                          context_parallel=cp)
    local_p = tree_map(lambda t, sp: local_block(t, sp, mesh).clone(),
                       params, p_specs)
    local_s = tree_map(lambda t, sp: local_block(t, sp, mesh).clone(),
                       st0, s_specs)
    spec_list = []
    tree_map(spec_list.append, s_specs)
    group = mesh.get_group("model")
    tp = mesh.size(mesh.mesh_dim_names.index("model"))

    def vocab(logits):
        parts = [torch.empty_like(logits) for _ in range(tp)]
        dist.all_gather(parts, logits.contiguous(), group=group)
        return torch.cat(parts, -1)

    def state_err(mine, full):
        return max(float((a - local_block(f, sp, mesh)).abs().max())
                   / max(float(f.abs().max()), 1e-30)
                   for a, f, sp in zip(tree_leaves(mine), tree_leaves(full),
                                       spec_list))

    mesh_logits, errs = [], []
    h, out = prefill(local_p, batch, cfg, local_s, mesh=mesh,
                     specs=p_specs, state_specs=s_specs)
    in_place = out is local_s
    mesh_logits.append(vocab(serve_logits(local_p, h, cfg, mesh=mesh,
                                          specs=p_specs, global_batch=b)))
    errs.append(state_err(local_s, single_states[0]))
    prepared = mesh_params(local_p, cfg, mesh, p_specs)   # the decode's
    for i, (tok, pos) in enumerate(steps):
        h, out = decode_step(prepared, tok, cfg, local_s,
                             pos if pos.ndim else int(pos), mesh=mesh,
                             state_specs=s_specs)
        in_place &= out is local_s
        mesh_logits.append(vocab(serve_logits(
            prepared, h, cfg, mesh=mesh, global_batch=b)))
        errs.append(state_err(local_s, single_states[i + 1]))
    got = {"logits": [(m.numpy(), x.numpy()) for m, x in
                      zip(mesh_logits, single_logits)],
           "state_err": max(errs), "in_place": in_place,
           "input_untouched": untouched}
    # the first block's local shape and spec of each state leaf kind
    for leaf in ("k", "conv", "ssm", "wkv", "x_prev_tm"):
        blk = first_block(local_s, leaf)
        if blk is not None:
            got[f"{leaf}_local"] = list(local_s[blk][leaf].shape)
            got[f"{leaf}_spec"] = list(map(str, s_specs[blk][leaf]))
    if "k_local" in got:                 # (heads, head_dim) of the cache
        got["cache_local"] = got["k_local"][-2:]
        got["cache_spec"] = got["k_spec"]
    return got


def main() -> int:
    rank, world, store, in_dir, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    with open(os.path.join(in_dir, "cases.json")) as f:
        cases = json.load(f)
    with np.load(os.path.join(in_dir, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    res, arrays = {}, {}
    try:
        for case in cases:
            name = case["name"]
            got = run_case(case, {k.split(SEP)[-1]: v for k, v in
                                  inputs.items()
                                  if k.startswith(name + SEP)},
                           in_dir)
            for i, (m, x) in enumerate(got.pop("logits")):
                arrays[f"{name}{SEP}mesh{SEP}{i}"] = m
                arrays[f"{name}{SEP}single{SEP}{i}"] = x
            per_rank = [None] * world
            dist.all_gather_object(per_rank, got)
            res[name] = per_rank
        res["jax_loaded"] = any(k == "jax" or k.startswith("jax.")
                                for k in sys.modules)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(out, "logits.npz"), **arrays)
        with open(os.path.join(out, "result.json"), "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

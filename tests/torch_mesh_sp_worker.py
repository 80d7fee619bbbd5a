"""One rank of the check of sequence-parallel activations (gloo).

    python tests/torch_mesh_sp_worker.py RANK WORLD STORE IN OUT

Joins a gloo group of WORLD ranks through a ``FileStore`` at STORE and
runs, from ``IN/cases.json``:

* every step case: two steps of ``make_train_step(..., mesh=)`` under the
  case's config with ``act_sharding="sp"`` and with ``"dp"`` (the
  tensor-parallel step whose activations stay whole), from the JAX
  package's initial weights (``IN/{arch}_params.npz``, carried by
  ``convert.train_state``), against two steps of the port's one-process
  step, on the batches in ``IN/batches.npz``: the three losses and grad
  norms, each step's gradients that reach AdamW (the mesh steps'
  gathered) leaf by leaf against the one-process leaf's largest, the
  ``sp`` step's gathered weights against the one-process AdamW's two
  steps on its gradients, the ``seq`` axes each step's context set and
  the shapes of the residual stream every norm between blocks read;
* every prefill case: ``prefill(..., mesh=)`` and ``serve_logits`` from
  this rank's shards of the JAX package's weights (``convert.lm_params``)
  under ``"sp"`` and ``"dp"``, and the single process's ``prefill``: the
  logits (the vocab gathered here) and the residual stream's shapes.

On rank 0 it writes ``OUT/result.json`` and ``OUT/logits.npz``.  Imports
torch, numpy and ``repro_torch`` only — never jax.
``tests/test_torch_mesh_sp.py`` spawns WORLD of these.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(__file__))

import torch_mesh_worker as base  # noqa: E402
from torch_mesh_train_tp_worker import (LR, _err, _rel, batches,  # noqa: E402
                                        gathered)

SEP = "//"


def config(case, act):
    from repro_torch.configs import get_config

    cfg = get_config(case["arch"], smoke=True)
    return dataclasses.replace(cfg, **case.get("replace", {}),
                               act_sharding=act)


class Spy:
    """Records, while on, the shape of every activation a norm between
    blocks reads (``transformer.apply_norm``) and the ``seq`` axes each
    sharding context names."""

    def __init__(self):
        from repro_torch.models import shard_ctx
        from repro_torch.models import transformer as T

        self.T, self.S = T, shard_ctx
        self.norm, self.ctx = T.apply_norm, shard_ctx.set_sharding_context
        self.shapes, self.seq = set(), set()

    def __enter__(self):
        def norm(p, x, cfg, *a, **k):
            self.shapes.add(tuple(x.shape))
            return self.norm(p, x, cfg, *a, **k)

        def ctx(*a, **k):
            self.seq.add(tuple(k.get("seq", ())))
            return self.ctx(*a, **k)

        self.T.apply_norm, self.S.set_sharding_context = norm, ctx
        return self

    def __exit__(self, *exc):
        self.T.apply_norm, self.S.set_sharding_context = self.norm, self.ctx

    def result(self) -> dict:
        return {"shapes": sorted(map(list, self.shapes)),
                "seq": sorted(map(list, self.seq))}


def step_case(case, in_dir) -> dict:
    from repro_torch.launch.sharding import (distribute_state, gather_state,
                                             param_specs)
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train import (OptimizerConfig, adamw_update,
                                   make_train_step)
    from repro_torch.train import train_step as TS

    cfg = config(case, "sp")
    mesh = base.mesh_of(case["mesh"])
    opt = OptimizerConfig(lr=LR, warmup_steps=1, total_steps=10,
                          eps=case["eps"])
    s0 = base.ported_state(case["arch"], cfg)
    runs = {"single": (s0, make_train_step(cfg, opt))}
    for act in ("sp", "dp"):
        c = config(case, act)
        runs[act] = (distribute_state(base.ported_state(case["arch"], c),
                                      mesh, c),
                     make_train_step(c, opt, mesh=mesh, donate=True))
    specs = param_specs(s0.params, mesh, cfg)
    seen, real = {k: [] for k in runs}, TS.adamw_update
    spies = {k: Spy() for k in runs}
    rows = []
    for b in batches(case, in_dir):
        row = {}
        for k, (st, step) in runs.items():
            def spy(params, grads, *args, _k=k, **kw):
                seen[_k].append([g.detach().clone()
                                 for g in tree_leaves(grads)])
                return real(params, grads, *args, **kw)

            TS.adamw_update = spy
            try:
                with spies[k]:
                    st, m = step(st, b)
            finally:
                TS.adamw_update = real
            runs[k] = (st, step)
            row[k] = {n: float(m[n]) for n in ("loss", "grad_norm")}
        rows.append(row)
    names = [n for n, _ in base._names(s0.params)]
    leaves_specs = list(tree_leaves(specs))
    mesh_g = {k: [[gathered(x, sp, mesh) for x, sp in zip(g, leaves_specs)]
                  for g in seen[k]] for k in ("sp", "dp")}
    grads = {k: [[n, max(_rel(mesh_g[k][i][j], seen["single"][i][j])
                         for i in (0, 1))]
                 for j, n in enumerate(names)] for k in ("sp", "dp")}
    sp_vs_dp = max(_rel(a, b) for i in (0, 1)
                   for a, b in zip(mesh_g["sp"][i], mesh_g["dp"][i]))
    replay = base.ported_state(case["arch"], cfg)
    p, o = replay.params, replay.opt
    for i in (0, 1):
        it = iter(mesh_g["sp"][i])
        p, o, _ = adamw_update(p, tree_map(lambda _: next(it), p), o, opt)
    g = gather_state(runs["sp"][0])
    adamw = max(_err(a, b) for a, b in zip(tree_leaves(g.params),
                                           tree_leaves(p)))
    return {"metrics": rows, "grads": grads, "sp_vs_dp": sp_vs_dp,
            "adamw": adamw, "steps": [int(g.step), int(g.opt.step)],
            "residual": {k: v.result() for k, v in spies.items()}}


def prefill_case(case, in_dir, logits: dict) -> dict:
    from repro_torch import convert
    from repro_torch.launch.sharding import (local_block, param_specs,
                                             state_specs)
    from repro_torch.models import init_decode_state, prefill
    from repro_torch.models.transformer import serve_logits, tree_map

    mesh = base.mesh_of(case["mesh"])
    with np.load(os.path.join(in_dir, "prompts.npz")) as z:
        tokens = torch.from_numpy(z[case["name"]])
    b, s = tokens.shape
    tree = base.load_tree(os.path.join(in_dir,
                                       f"{case['arch']}_params.npz"))
    tree.setdefault("head", {})
    group = mesh.get_group("model")
    tp = mesh.size(mesh.mesh_dim_names.index("model"))

    def vocab(t):
        parts = [torch.empty_like(t) for _ in range(tp)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, -1)

    out = {}
    for act in ("sp", "dp"):
        cfg = config(case, act)
        params = convert.lm_params(tree, cfg, device="cpu")
        st0 = init_decode_state(cfg, b, s, torch.float32, device="cpu")
        if act == "sp":
            h, _ = prefill(params, {"tokens": tokens}, cfg, st0)
            logits[f"{case['name']}{SEP}single"] = \
                serve_logits(params, h, cfg).numpy()
        p_specs = param_specs(params, mesh, cfg)
        s_specs = state_specs(st0, mesh, cfg, global_batch=b)
        local_p = tree_map(lambda t, sp: local_block(t, sp, mesh).clone(),
                           params, p_specs)
        local_s = tree_map(lambda t, sp: local_block(t, sp, mesh).clone(),
                           st0, s_specs)
        with Spy() as spy:
            h, _ = prefill(local_p, {"tokens": tokens}, cfg, local_s,
                           mesh=mesh, specs=p_specs)
        logits[f"{case['name']}{SEP}{act}"] = vocab(serve_logits(
            local_p, h, cfg, mesh=mesh, specs=p_specs,
            global_batch=b)).numpy()
        out[act] = {**spy.result(), "hidden": list(h.shape)}
    return out


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, in_dir, out_dir = sys.argv[3:6]
    base.IN = in_dir
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    cases = json.loads(open(os.path.join(in_dir, "cases.json")).read())
    res: dict = {}
    logits: dict = {}
    try:
        for case in cases:
            got = step_case(case, in_dir) if case["kind"] == "step" \
                else prefill_case(case, in_dir, logits)
            res[case["name"]] = base.gather_to_rank0(got)
        res["jax_loaded"] = any(k == "jax" or k.startswith("jax.")
                                for k in sys.modules)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(out_dir, "logits.npz"), **logits)
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

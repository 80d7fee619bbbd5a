"""One rank of the check of the tensor-parallel mesh train step (gloo).

    python tests/torch_mesh_train_tp_worker.py RANK WORLD STORE IN OUT

Joins a gloo group of WORLD ranks through a ``FileStore`` at STORE and
runs, from ``IN/cases.json``:

* every step case: two steps of ``make_train_step(..., mesh=)`` on its
  (data, model) mesh from the JAX package's initial weights (``IN/{arch}
  _params.npz``, carried by ``convert.train_state``) against two steps of
  the port's one-process step, on the batches in ``IN/batches.npz``: the
  losses and grad norms of both, each step's gradients that reach AdamW
  (the mesh step's gathered) leaf by leaf, each against the largest of
  the one-process leaf, the gathered weights' largest difference from
  the one-process step's and from the one-process AdamW's two steps on
  the mesh step's gradients, the steps, and what
  ``launch.sharding.tp_layout`` kept on `model`;
* every loss case: ``layers.chunked_xent`` under a tensor-parallel
  context on the rank's vocab block of the head (or of the tied
  embedding) against the unsplit loss on the whole weights: the loss,
  and the gradients of x and of the rank's block, each against the
  largest of the unsplit one.

On rank 0 it writes ``OUT/result.json``.  Imports torch, numpy and
``repro_torch`` only — never jax.  ``tests/test_torch_mesh_train_tp.py``
spawns WORLD of these and holds the numbers to the reference's.
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

LR = 1e-3


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _rel(a, b) -> float:
    return _err(a, b) / max(float(b.double().abs().max()), 1e-30)


def config(case):
    from repro_torch.configs import get_config

    cfg = get_config(case["arch"], smoke=True)
    return dataclasses.replace(cfg, **case.get("replace", {}))


def batches(case, in_dir) -> list:
    with np.load(os.path.join(in_dir, "batches.npz")) as z:
        return [{k.split("//")[2]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith(f"{case['name']}//{i}//")}
                for i in range(2)]


def kept(specs, mesh, cfg) -> dict:
    """``{leaf path: [keep, partial]}`` of the first unit's block 0 (and
    the encoder's), the embedding and the head, from ``tp_layout``."""
    from repro_torch.launch.sharding import tp_layout

    layout = tp_layout(specs, mesh, cfg)
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif path[0] not in ("units", "enc_units") or path[1] == "b0":
            out["/".join(path)] = [list(tree[0]), list(tree[1])]

    walk(layout, ())
    return out


def gathered(local, spec, mesh) -> torch.Tensor:
    """A leaf's local shard under ``spec`` all-gathered (every rank)."""
    from repro_torch.models.shard_ctx import _all_gather

    for d, entry in enumerate(spec):
        if entry is not None:
            local = _all_gather(local, d, mesh, entry)
    return local


def step_case(case, in_dir) -> dict:
    from repro_torch.launch.sharding import (distribute_state, gather_state,
                                             param_specs)
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train import (OptimizerConfig, adamw_update,
                                   make_train_step)
    from repro_torch.train import train_step as TS

    cfg = config(case)
    mesh = base.mesh_of(case["mesh"])
    opt = OptimizerConfig(lr=LR, warmup_steps=1, total_steps=10,
                          eps=case["eps"])
    s0 = base.ported_state(case["arch"], cfg)
    s1 = distribute_state(base.ported_state(case["arch"], cfg), mesh, cfg)
    specs = param_specs(s0.params, mesh, cfg)
    step0 = make_train_step(cfg, opt)
    step1 = make_train_step(cfg, opt, mesh=mesh, donate=True)
    seen, real = [], TS.adamw_update

    def spy(params, grads, *args, **kw):       # the gradients AdamW takes
        seen.append([g.detach().clone() for g in tree_leaves(grads)])
        return real(params, grads, *args, **kw)

    rows = []
    TS.adamw_update = spy
    try:
        for b in batches(case, in_dir):
            s0, m0 = step0(s0, b)
            s1, m1 = step1(s1, b)
            rows.append({k: [float(m0[k]), float(m1[k])]
                         for k in ("loss", "grad_norm")})
    finally:
        TS.adamw_update = real
    g = gather_state(s1)
    names = [n for n, _ in base._names(s0.params)]
    # seen: one-process, mesh, one-process, mesh (a step's each)
    mesh_g = [[gathered(x, sp, mesh) for x, sp in zip(seen[i],
                                                      tree_leaves(specs))]
              for i in (1, 3)]
    grads = [[n, max(_rel(mesh_g[k][j], seen[2 * k][j]) for k in (0, 1)),
              float(seen[0][j].abs().max())] for j, n in enumerate(names)]
    # the one-process AdamW on the mesh step's gradients, from the start
    replay = base.ported_state(case["arch"], cfg)
    p, o = replay.params, replay.opt
    for k in (0, 1):
        it = iter(mesh_g[k])
        p, o, _ = adamw_update(p, tree_map(lambda _: next(it), p), o, opt)
    moved = [[n, _err(a, b) / LR, _err(b, c) / LR] for n, a, b, c in zip(
        names, tree_leaves(s0.params), tree_leaves(g.params),
        tree_leaves(p))]
    return {"metrics": rows,
            "weights": max(d for _, d, _ in moved) * LR,
            "adamw": max(d for _, _, d in moved) * LR,
            "grads": grads,
            "weights_lr": moved,
            "steps": [int(g.step), int(g.opt.step)],
            "layout": kept(specs, mesh, cfg)}


def loss_case(case) -> dict:
    """The vocab-parallel loss on the rank's block of the vocab against
    the unsplit loss, both through ``chunked_xent`` (two chunks)."""
    from repro_torch.launch.sharding import local_block
    from repro_torch.models import init_model, shard_ctx
    from repro_torch.models.layers import chunked_xent, pad_vocab

    cfg = config(case)
    mesh = base.mesh_of(case["mesh"])
    full = init_model(0, cfg, device="cpu")
    gen = np.random.default_rng(7)
    b, s = 2, 16
    x = torch.from_numpy(gen.standard_normal((b, s, cfg.d_model))
                         .astype(np.float32))
    labels = gen.integers(0, cfg.vocab_size, (b, s))
    labels[0, :4] = cfg.vocab_size - 1 - np.arange(4)     # the last block's
    mask = (gen.random((b, s)) < 0.9).astype(np.float32)
    name = "embedding" if cfg.tie_embeddings else "w_head"
    w = (full["embed"] if cfg.tie_embeddings else full["head"])[name]
    spec = ("model", None) if cfg.tie_embeddings else (None, "model")

    def run(weight, split):
        xx = x.clone().requires_grad_(True)
        ww = weight.clone().requires_grad_(True)
        head = {} if cfg.tie_embeddings else {"w_head": ww}
        emb = {"embedding": ww} if cfg.tie_embeddings else {}
        if split:
            shard_ctx.set_sharding_context(mesh, (), tp=("model",))
        try:
            loss = chunked_xent(head, emb, xx, labels, mask, cfg, chunk=8)
            loss.backward()
        finally:
            shard_ctx.clear_sharding_context()
        return loss.detach(), xx.grad, ww.grad

    l0, gx0, gw0 = run(w, False)
    l1, gx1, gw1 = run(local_block(w, spec, mesh), True)
    n = shard_ctx.group_size(mesh, "model")
    last = pad_vocab(cfg.vocab_size) // n * (n - 1)
    return {"loss": abs(float(l1) - float(l0)) / abs(float(l0)),
            "xgrad": _rel(gx1, gx0),
            "wgrad": _rel(gw1, local_block(gw0, spec, mesh)),
            "block": list(local_block(w, spec, mesh).shape),
            "labels_in_last_block": int((labels >= last).sum())}


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, in_dir, out_dir = sys.argv[3:6]
    base.IN = in_dir
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    cases = json.loads(open(os.path.join(in_dir, "cases.json")).read())
    res: dict = {}
    try:
        for case in cases:
            got = step_case(case, in_dir) if case["kind"] == "step" \
                else loss_case(case)
            res[case["name"]] = base.gather_to_rank0(got)
        res["jax_loaded"] = any(k == "jax" or k.startswith("jax.")
                                for k in sys.modules)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

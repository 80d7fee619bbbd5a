"""The tensor-parallel mesh train step on gloo ranks against its single
process and the JAX package.

``tests/torch_mesh_train_tp_worker.py`` runs as 4 processes in one gloo
group (a ``FileStore`` rendezvous in ``tmp_path``, joined with a
timeout); the children import no jax.  The weights are the JAX package's
(``init_model(PRNGKey(0))`` at smoke size, MoE at capacity factor 8, so
that no token is dropped and the distributed MoE's per-shard capacity
keeps the same tokens as one device's), carried by ``convert.train_state``.

* **step**: two steps of ``make_train_step(..., mesh=)`` against the
  reference's single-device step and the port's one-process step, held
  to ``tests/test_torch_mesh.py::_check_step``'s bounds — losses within
  2e-3 of the reference's and 1e-5 relative of the port's, grad norms
  within 1e-4, the weights within 1 % of lr (as below) — on (data, model) =
  (2, 2) for all ten architectures (every block split over `model`:
  attention, MLP, MoE — grok's ``"ffn"`` experts on d_ff —, jamba's Mamba
  on d_inner, rwkv6's time mix on heads and its channel mix on d_ff), and
  llama3_2_1b on (1, 4), whose 2 kv heads do not divide `model`: the kv
  projection splits on columns and k and v are gathered, and llama3_2_1b
  with fsdp and ``dp_over_model`` on (2, 2) (the batch on both axes, no
  split).  AdamW's eps is its default, 1e-8.  The step is held in two
  halves, as ``chip_smoke.py``'s ``step_vs_cpu`` holds 11h's: every
  leaf's gradient (each step's) within 1e-4 of its largest, and the
  weights within 1 % of lr of what the one-process AdamW makes of the
  mesh step's gradients.  Against the one-process step's own weights they
  read up to 2.5 % of lr (jamba, gemma2): at eps 1e-8 AdamW's first step
  maps g to g/(|g| + eps), so an element whose gradient is a few eps
  (gemma2's ``w_down``: 2.9e-8, 9e-7 of the leaf's largest) turns a
  difference at fp32's rounding of the leaf's sums (2.8e-9, 9e-8 of its
  largest) into ~2 % of lr.
* **loss**: ``chunked_xent`` on the rank's vocab block of the head (phi3,
  untied), of the tied embedding (llama3_2_1b), with gemma2's final
  softcap (tied), and with a 2,000-token vocab whose last block holds
  labels and the padded tail, on 2 ranks (the model axis of (2, 2)) and
  on 4 ((1, 4)): the loss and the gradients of x and of the rank's block
  within 1e-5 of the unsplit loss's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import init_model as jinit_model
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.data import SyntheticTokenDataset

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_mesh_train_tp_worker.py")
JOIN_TIMEOUT = 420
WORLD = 4
LR = 1e-3
EPS = 1e-8
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
ARCHS = ("llama3_2_1b", "yi_6b", "gemma2_2b", "phi3_mini_3_8b",
         "chameleon_34b", "moonshot_v1_16b_a3b", "grok_1_314b",
         "whisper_tiny", "jamba_1_5_large_398b", "rwkv6_7b")
MESHES = {"dm22": {"data": 2, "model": 2}, "dm14": {"data": 1, "model": 4}}
# (arch, mesh, the port's config replaced): the last puts the batch on
# `model` too (no tensor-parallel split) with the params sharded over both
STEP_CASES = [(a, "dm22", {}) for a in ARCHS] + [
    ("llama3_2_1b", "dm14", {}),
    ("llama3_2_1b", "dm22", {"fsdp": True, "dp_over_model": True})]
STEP_IDS = [f"{a}-{m}" + ("-dpom" if r else "") for a, m, r in STEP_CASES]
LOSS_VARIANTS = {"untied": ("phi3_mini_3_8b", {}),
                 "tied": ("llama3_2_1b", {}),
                 "softcap": ("gemma2_2b", {}),
                 "tail": ("llama3_2_1b", {"vocab_size": 2000})}
LOSS_IDS = [f"loss-{v}-{m}" for v in LOSS_VARIANTS for m in MESHES]


def jconfig(arch):
    cfg = jget_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def _save_tree(path, tree) -> None:
    flat = {"//".join(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(path, **flat)


def _batches(cfg) -> list:
    ds = SyntheticTokenDataset(cfg.vocab_size, 32, 4, seed=5)
    out = []
    for i in range(2):
        b = ds.train_inputs(i)
        if cfg.family == "encdec":
            b["enc_frames"] = np.random.default_rng(i).standard_normal(
                (4, 32, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _reference_losses(cfg, params, batches) -> list:
    step = jax.jit(jmake_train_step(cfg, JOptimizerConfig(
        lr=LR, warmup_steps=1, total_steps=10, eps=EPS)))
    st, out = jinit_train_state(params, cfg), []
    for b in batches:
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The workers' results and the reference's losses (computed here
    while the workers run)."""
    d = tmp_path_factory.mktemp("mesh_train_tp")
    in_dir, out_dir = d / "in", d / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    params, batches, cases = {}, {}, []
    for arch in ARCHS:
        cfg = jconfig(arch)
        params[arch] = jinit_model(jax.random.PRNGKey(0), cfg)
        _save_tree(in_dir / f"{arch}_params.npz", params[arch])
    for name, (arch, mesh, rep) in zip(STEP_IDS, STEP_CASES):
        cfg = jconfig(arch)
        batches[name] = _batches(cfg)
        cases.append({"kind": "step", "name": name, "arch": arch,
                      "mesh": MESHES[mesh], "eps": EPS,
                      "replace": {**rep, **({"capacity_factor": 8.0}
                                           if cfg.n_experts else {})}})
    for variant, (arch, rep) in LOSS_VARIANTS.items():
        for mesh in MESHES:
            cases.append({"kind": "loss", "name": f"loss-{variant}-{mesh}",
                          "arch": arch, "mesh": MESHES[mesh],
                          "replace": rep})
    np.savez(in_dir / "batches.npz", **{
        f"{n}//{i}//{k}": v for n, bs in batches.items()
        for i, b in enumerate(bs) for k, v in b.items()})
    (in_dir / "cases.json").write_text(json.dumps(cases))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD), str(d / "store"),
         str(in_dir), str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_TIMEOUT
    errors = []
    try:
        ref = {name: _reference_losses(jconfig(arch), params[arch],
                                       batches[name])
               for name, (arch, _, _) in zip(STEP_IDS, STEP_CASES)}
        for p in procs:
            _, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            if p.returncode:
                errors.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, errors[0]
    return json.loads((out_dir / "result.json").read_text()), ref


def _check_step(got, ref_losses):
    """``tests/test_torch_mesh.py::_check_step``'s bounds, on every rank,
    with the step held in its two halves: each step's gradient of every
    leaf within ``GRAD_TOL`` of the leaf's largest in the one-process step
    (AdamW's first steps are near sign(g), blind to a gradient's scale),
    and the weights within 1 % of lr of the one-process AdamW's two steps
    on the mesh step's gathered gradients."""
    for res in got:
        for r, row in zip(ref_losses, res["metrics"]):
            single, sharded = row["loss"]
            assert abs(sharded - r) <= 2e-3, (r, row)
            assert abs(sharded - single) <= 1e-5 * abs(single), row
            g1, g2 = row["grad_norm"]
            assert abs(g1 - g2) <= 1e-4 * g1, row
        bad = [g for g in res["grads"] if not g[1] <= GRAD_TOL]
        assert not bad, bad
        assert res["adamw"] <= 0.01 * LR, max(
            res["weights_lr"], key=lambda w: w[2])
        assert res["steps"] == [2, 2]


@pytest.mark.parametrize("case", STEP_IDS)
def test_tp_step_matches_single_process_and_reference(ranks, case):
    res, ref = ranks
    assert len(res[case]) == WORLD
    _check_step(res[case], ref[case])


def _layout(ranks, case):
    return ranks[0][case][0]["layout"]


def test_attention_mlp_and_vocab_stay_split_on_two_by_two(ranks):
    """llama3_2_1b on (2, 2): every attention, MLP, embedding leaf keeps
    its `model` shard; the norms are gathered; no leaf is summed over
    `model` (its kv heads divide the axis)."""
    got = _layout(ranks, "llama3_2_1b-dm22")
    for leaf in ("w_q", "w_k", "w_v", "w_o"):
        assert got[f"units/b0/mixer/{leaf}"] == [["model"], []], leaf
    for leaf in ("w_gate", "w_up", "w_down"):
        assert got[f"units/b0/ffn/{leaf}"] == [["model"], []], leaf
    assert got["embed/embedding"] == [["model"], []]
    assert got["units/b0/ln1/scale"] == [[], []]


def test_kv_projection_splits_on_columns_on_one_by_four(ranks):
    """llama3_2_1b on (1, 4): 2 kv heads on 4 model ranks — ``w_k`` and
    ``w_v`` keep their 8-column blocks (the layer gathers k and v)."""
    got = _layout(ranks, "llama3_2_1b-dm14")
    for leaf in ("w_q", "w_k", "w_v", "w_o"):
        assert got[f"units/b0/mixer/{leaf}"] == [["model"], []], leaf


def test_grok_ffn_experts_split_on_d_ff(ranks):
    got = _layout(ranks, "grok_1_314b-dm22")
    for leaf in ("we_gate", "we_up", "we_down"):
        assert got[f"units/b0/ffn/{leaf}"] == [["model"], []], leaf
    assert got["units/b0/ffn/router"] == [[], []]


KEEP, PARTIAL, WHOLE = [["model"], []], [[], ["model"]], [[], []]
# (2, 2): each Mamba and RWKV leaf's [keep, partial] in the step's gather
RECURRENT_LAYOUT = {
    "jamba_1_5_large_398b": {
        **{f"mixer/{n}": KEEP for n in (
            "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
            "A_log", "D", "out_proj")},
        **{f"ffn/{n}": KEEP for n in ("w_gate", "w_up", "w_down")},
        "ln1/scale": WHOLE},
    "rwkv6_7b": {
        **{f"mixer/{n}": KEEP for n in (
            "w_r", "w_k", "w_v", "w_g", "w_o", "bonus_u")},
        **{f"mixer/{n}": PARTIAL for n in ("decay_base", "decay_b",
                                            "ln_x")},
        **{f"mixer/{n}": WHOLE for n in ("mu_x", "mu_rwkvg", "lora_a",
                                          "lora_b", "decay_a")},
        **{f"ffn/{n}": KEEP for n in ("w_k", "w_r", "w_v")},
        "ffn/mu_k": WHOLE, "ffn/mu_r": WHOLE},
}


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "rwkv6_7b"])
def test_mamba_and_rwkv_blocks_gathered_over_model(ranks, arch):
    """On (2, 2) no Mamba or RWKV leaf that its layer splits is gathered
    over `model` any more: jamba's Mamba keeps every d_inner block
    (``in_proj``'s column blocks too, re-laid out by one all-to-all),
    rwkv6's time mix its heads — ``decay_base``/``decay_b``/``ln_x``
    whole but summed over `model` (each rank reads its channels) and the
    ddlerp half whole — and its channel mix d_ff and d; jamba's MLP
    keeps its shards.  Every leaf of the block is asserted."""
    got = _layout(ranks, f"{arch}-dm22")
    want = RECURRENT_LAYOUT[arch]
    for leaf, layout in want.items():
        assert got[f"units/b0/{leaf}"] == layout, (arch, leaf)
    block = {k for k in got if k.startswith(("units/b0/mixer",
                                             "units/b0/ffn"))}
    asserted = {f"units/b0/{k}" for k in want}
    assert block <= asserted, block - asserted


@pytest.mark.parametrize("case", LOSS_IDS)
def test_vocab_parallel_loss_matches_unsplit(ranks, case):
    res, _ = ranks
    for got in res[case]:
        assert got["loss"] <= LOSS_TOL, got
        assert got["xgrad"] <= LOSS_TOL, got
        assert got["wgrad"] <= LOSS_TOL, got
    n = MESHES[case.split("-")[-1]]["model"]
    blocks = {tuple(got["block"]) for got in res[case]}
    assert len(blocks) == 1 and 2048 // n in next(iter(blocks)), blocks
    if "-tail-" in case:              # labels in the last (padded) block
        assert res[case][0]["labels_in_last_block"] > 0


def test_rules_keep_rwkv_time_mix_gathered():
    """RWKV's time mix names leaves ``w_k``/``w_v``/``w_o`` as attention
    does, and the param rules shard them on `model` alike; the layout
    keys on the block's kind.  At |model| = 16 rwkv6_7b's 64 heads split
    4 a rank, so they keep their shards as llama's attention does (its
    ``w_k`` on columns), and the train step sums the whole leaves its
    ranks read on their own channels over `model` as well as the batch's
    axes; jamba's Mamba keeps its d_inner blocks (1,024 of 16,384)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import abstract_params
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.launch.sharding import param_specs, tp_layout
    from repro_torch.train.train_step import mesh_gather_rules

    mesh = production_mesh_shape()
    for arch, keep in (("rwkv6_7b", ("model",)), ("llama3_2_1b",
                                                  ("model",))):
        cfg = get_config(arch)
        specs = param_specs(abstract_params(cfg), mesh, cfg)
        layout = tp_layout(specs, mesh, cfg)["units"]["b0"]["mixer"]
        rules = mesh_gather_rules(specs, mesh, cfg, ("data",), 4096)[
            "units"]["b0"]["mixer"]
        for leaf in ("w_k", "w_v", "w_o"):
            assert "model" in specs["units"]["b0"]["mixer"][leaf], leaf
            assert layout[leaf] == (keep, ()), (arch, leaf)
            assert rules[leaf][1:] == (("data",), keep), (arch, leaf)
        if arch == "rwkv6_7b":
            for leaf in ("decay_base", "decay_b", "ln_x"):
                assert layout[leaf] == ((), ("model",)), leaf
                assert rules[leaf][1:] == (("data", "model"), ()), leaf
            assert layout["lora_a"] == ((), ())
    cfg = get_config("jamba_1_5_large_398b")
    specs = param_specs(abstract_params(cfg), mesh, cfg)
    mamba = tp_layout(specs, mesh, cfg)["units"]["b0"]["mixer"]
    assert mamba and all(v == (("model",), ()) for v in mamba.values())
    assert specs["units"]["b0"]["mixer"]["in_proj"][-1] == "model"


@pytest.mark.parametrize("arch,replace", [
    ("rwkv6_7b", {"d_ff": 130}),
    ("jamba_1_5_large_398b", {})])
def test_layout_refuses_a_partly_split_recurrent_block(arch, replace):
    """A Mamba or RWKV layer reads one layout for all its split leaves:
    rwkv6's channel mix with a d_ff of 130 on 4 `model` ranks would keep
    ``w_r``/``w_v`` (d 64) but gather ``w_k`` (130 columns), and
    ``tp_layout`` raises rather than run it; jamba's Mamba at smoke size
    (d_inner 128) keeps all of its leaves."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import abstract_params
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.sharding import param_specs, tp_layout

    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    mesh = ShapeMesh({"data": 1, "model": 4})
    specs = param_specs(abstract_params(cfg), mesh, cfg)
    if arch == "rwkv6_7b":
        with pytest.raises(ValueError, match="only some of its split"):
            tp_layout(specs, mesh, cfg)
    else:
        layout = tp_layout(specs, mesh, cfg)["units"]["b0"]["mixer"]
        assert all(v == (("model",), ()) for v in layout.values())


def test_batch_on_model_keeps_nothing_on_model(ranks):
    """llama3_2_1b with fsdp and ``dp_over_model`` on (2, 2): the fsdp
    dim shards over data and model together and the step's context splits
    nothing, so every leaf is gathered whole and summed over the batch's
    axes only."""
    got = _layout(ranks, "llama3_2_1b-dm22-dpom")
    assert got and all(v == [[], []] for v in got.values()), got


@pytest.mark.parametrize("dp_over_model", [False, True])
def test_layout_refuses_split_queries_on_a_whole_kv_projection(
        dp_over_model):
    """Query heads split over `model` with ``w_k``/``w_v`` left whole by
    their spec (1 kv head of 2 dims on 4 ranks) would give each rank a
    part of the kv gradient: ``tp_layout`` raises rather than compute it.
    With the batch on `model` nothing splits, and the layout is empty."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import abstract_params
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.sharding import param_specs, tp_layout
    from repro_torch.models.transformer import tree_leaves

    cfg = dataclasses.replace(get_config("llama3_2_1b", smoke=True),
                              n_heads=4, n_kv_heads=1, head_dim=2,
                              dp_over_model=dp_over_model)
    mesh = ShapeMesh({"data": 1, "model": 4})
    specs = param_specs(abstract_params(cfg), mesh, cfg)
    assert specs["units"]["b0"]["mixer"]["w_k"][-1] is None
    if dp_over_model:
        layout = tp_layout(specs, mesh, cfg)
        assert set(tree_leaves(layout)) == {((), ())}
    else:
        with pytest.raises(ValueError, match="kv projection whole"):
            tp_layout(specs, mesh, cfg)


def test_one_rank_groups_run_no_collective():
    """On a 1 × 1 mesh every ``shard_ctx`` collective is the identity and
    none runs: the mesh stand-in has no process group, so a call
    would raise.  Values and gradients are the unsplit ones."""
    import torch

    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models import shard_ctx as S

    mesh = ShapeMesh({"data": 1, "model": 1})
    x = torch.arange(24.0).reshape(4, 6).requires_grad_(True)
    y = S.copy_to(x, mesh, "model")
    y = S.gather_from(S.scatter_to(y, 0, mesh, "model"), 0, mesh, "model",
                      sum_grad=True)
    y = S.all_to_all(S.row_split(y, torch.eye(6), mesh, "model"), mesh,
                     ("data", "model"))
    w = S.gather_param(x, ("data", "model"), mesh, partial=("data",))
    (y * 2 + w).sum().backward()
    assert torch.equal(y, x) and torch.equal(w, x)
    assert torch.equal(x.grad, torch.full_like(x, 3.0))
    assert torch.equal(S.reduce_max(x, mesh, "model"), x)
    assert torch.equal(S.reduce_sum(x, mesh, ("data", "model")), x)


def test_mesh_train_tp_workers_import_no_jax(ranks):
    assert ranks[0]["jax_loaded"] is False

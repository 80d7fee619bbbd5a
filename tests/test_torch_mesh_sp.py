"""Sequence-parallel activations (``act_sharding="sp"``) on gloo ranks
against the single process, the tensor-parallel (``"dp"``) step and the
JAX package.

``tests/torch_mesh_sp_worker.py`` runs as 4 processes in one gloo group
(a ``FileStore`` rendezvous in ``tmp_path``, joined with a timeout); the
children import no jax.  The weights are the JAX package's
(``init_model(PRNGKey(0))`` at smoke size, MoE at capacity factor 8, so
that no token is dropped), carried by ``convert``.

* **step**: jamba (Mamba, attention, MLP and ``"expert"`` MoE: the
  all-to-all on the rank's block of the sequence), chameleon (attention
  with qk-norm, MLP) and grok (attention, ``"ffn"`` MoE: the sequence
  gathered, the d_ff split's output reduce-scattered) on (data, model) =
  (2, 2) and (1, 4), two steps each under ``"sp"`` and ``"dp"``: losses
  within ``tests/test_torch_mesh.py::_check_step``'s bounds of the
  reference's and the one-process step's, every leaf's gradient within
  1e-4 of its largest (``"sp"`` and ``"dp"`` alike), and the ``"sp"``
  weights within 1 % of lr of the one-process AdamW on its gradients.
  The residual stream between blocks — every norm's input — is
  ``(B_rank, S/|model|, d)`` under ``"sp"`` and ``(B_rank, S, d)`` under
  ``"dp"``.  chameleon with fsdp and ``dp_over_model`` on (2, 2), and on
  (1, 4) with 30 tokens a row (4 does not divide them), splits nothing.
* **prefill**: the three on (2, 2) and (1, 4), 4 × 16 tokens: the mesh's
  logits under ``"sp"`` and ``"dp"`` within 1e-4 of the single process's
  and of the JAX package's ``prefill`` + ``logits_fn``.

The gradient bound is what catches a double-counted gradient: a block
entry that all-reduced the gradient beside the sequence gather's
reduce-scatter would multiply it by |model|.
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
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_model as jinit_model
from repro.models import prefill as jprefill
from repro.models.layers import logits_fn as jlogits_fn
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.data import SyntheticTokenDataset

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_mesh_sp_worker.py")
JOIN_TIMEOUT = 420
WORLD = 4
LR = 1e-3
EPS = 1e-8
GRAD_TOL = 1e-4
TOL = 1e-4
BATCH, SEQ = 4, 32
ARCHS = ("jamba_1_5_large_398b", "chameleon_34b", "grok_1_314b")
MESHES = {"dm22": {"data": 2, "model": 2}, "dm14": {"data": 1, "model": 4}}
# (arch, mesh, the port's config replaced, tokens a row)
STEP_CASES = [(a, m, {}, SEQ) for a in ARCHS for m in MESHES] + [
    ("chameleon_34b", "dm22", {"fsdp": True, "dp_over_model": True}, SEQ),
    ("chameleon_34b", "dm14", {}, 30)]
STEP_IDS = [f"{a}-{m}" + ("-dpom" if r else "") + ("" if s == SEQ
                                                   else f"-s{s}")
            for a, m, r, s in STEP_CASES]
PREFILL_IDS = [f"prefill-{a}-{m}" for a in ARCHS for m in MESHES]
PROMPT = 16


def jconfig(arch):
    cfg = jget_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def _save_tree(path, tree) -> None:
    flat = {"//".join(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(path, **flat)


def _batches(cfg, seq) -> list:
    ds = SyntheticTokenDataset(cfg.vocab_size, seq, BATCH, seed=5)
    return [ds.train_inputs(i) for i in range(2)]


def _reference_losses(cfg, params, batches) -> list:
    step = jax.jit(jmake_train_step(cfg, JOptimizerConfig(
        lr=LR, warmup_steps=1, total_steps=10, eps=EPS)))
    st, out = jinit_train_state(params, cfg), []
    for b in batches:
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(float(m["loss"]))
    return out


def _reference_logits(cfg, params, tokens):
    st = jinit_decode_state(cfg, tokens.shape[0], tokens.shape[1],
                            jnp.float32)
    h, _ = jax.jit(lambda p, b, s: jprefill(p, b, cfg, s))(
        params, {"tokens": jnp.asarray(tokens)}, st)
    return np.asarray(jlogits_fn(params["head"], params["embed"], h, cfg))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The workers' results and logits, and the reference's losses and
    logits (computed here while the workers run)."""
    d = tmp_path_factory.mktemp("mesh_sp")
    in_dir, out_dir = d / "in", d / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    params, batches, cases, prompts = {}, {}, [], {}
    for arch in ARCHS:
        params[arch] = jinit_model(jax.random.PRNGKey(0), jconfig(arch))
        _save_tree(in_dir / f"{arch}_params.npz", params[arch])
    for name, (arch, mesh, rep, seq) in zip(STEP_IDS, STEP_CASES):
        cfg = jconfig(arch)
        batches[name] = _batches(cfg, seq)
        cases.append({"kind": "step", "name": name, "arch": arch,
                      "mesh": MESHES[mesh], "eps": EPS,
                      "replace": {**rep, **({"capacity_factor": 8.0}
                                           if cfg.n_experts else {})}})
    for name in PREFILL_IDS:
        _, arch, mesh = name.split("-")
        cfg = jconfig(arch)
        prompts[name] = np.random.default_rng(sum(map(ord, name))).integers(
            0, cfg.vocab_size, (BATCH, PROMPT))
        cases.append({"kind": "prefill", "name": name, "arch": arch,
                      "mesh": MESHES[mesh],
                      "replace": ({"capacity_factor": 8.0}
                                  if cfg.n_experts else {})})
    np.savez(in_dir / "batches.npz", **{
        f"{n}//{i}//{k}": v for n, bs in batches.items()
        for i, b in enumerate(bs) for k, v in b.items()})
    np.savez(in_dir / "prompts.npz", **prompts)
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
               for name, (arch, _, _, _) in zip(STEP_IDS, STEP_CASES)}
        for name in PREFILL_IDS:
            arch = name.split("-")[1]
            ref[name] = _reference_logits(jconfig(arch), params[arch],
                                          prompts[name])
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
    res = json.loads((out_dir / "result.json").read_text())
    with np.load(out_dir / "logits.npz") as z:
        logits = {k: z[k] for k in z.files}
    return res, logits, ref


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("case", STEP_IDS)
def test_sp_step_matches_single_process_tp_step_and_reference(ranks, case):
    """``tests/test_torch_mesh_train_tp.py``'s bounds, every rank: losses
    and grad norms, each leaf's gradient under ``"sp"`` and ``"dp"``, and
    the ``"sp"`` weights against the one-process AdamW on its
    gradients."""
    res, _, ref = ranks
    assert len(res[case]) == WORLD
    for got in res[case]:
        for r, row in zip(ref[case], got["metrics"]):
            single = row["single"]["loss"]
            for act in ("sp", "dp"):
                assert abs(row[act]["loss"] - r) <= 2e-3, (act, r, row)
                assert abs(row[act]["loss"] - single) <= \
                    1e-5 * abs(single), (act, row)
                g1, g2 = row["single"]["grad_norm"], row[act]["grad_norm"]
                assert abs(g1 - g2) <= 1e-4 * g1, (act, row)
        for act in ("sp", "dp"):
            bad = [g for g in got["grads"][act] if not g[1] <= GRAD_TOL]
            assert not bad, (act, bad)
        assert got["sp_vs_dp"] <= GRAD_TOL, got["sp_vs_dp"]
        assert got["adamw"] <= 0.01 * LR, got["adamw"]
        assert got["steps"] == [2, 2]


def _mesh(case):
    return MESHES[case.split("-")[1]] if not case.startswith("prefill") \
        else MESHES[case.split("-")[2]]


@pytest.mark.parametrize("case", [c for c in STEP_IDS
                                  if "-dpom" not in c and "-s30" not in c])
def test_sp_residual_stream_is_the_ranks_sequence_block(ranks, case):
    """Every norm between blocks (and the final norm) reads ``(B_rank,
    S/|model|, d)`` under ``"sp"``, ``(B_rank, S, d)`` under ``"dp"``, and
    the steps' context names `model` as the sequence's axis under
    ``"sp"`` only."""
    res, _, _ = ranks
    mesh = _mesh(case)
    rows = BATCH // mesh["data"]
    for got in res[case]:
        r = got["residual"]
        assert r["sp"]["shapes"] == [[rows, SEQ // mesh["model"], 64]], r
        assert r["dp"]["shapes"] == [[rows, SEQ, 64]], r
        assert r["sp"]["seq"] == [["model"]] and r["dp"]["seq"] == [[]], r


@pytest.mark.parametrize("case", ["chameleon_34b-dm22-dpom",
                                  "chameleon_34b-dm14-s30"])
def test_sp_splits_nothing_on_model_batch_or_undivided_sequence(ranks,
                                                                 case):
    """With ``dp_over_model`` the batch is on `model`; with 30 tokens on
    4 `model` ranks the sequence does not divide: the ``"sp"`` step's
    residual stream is whole, as the reference's constraint leaves it."""
    res, _, _ = ranks
    mesh = _mesh(case)
    for got in res[case]:
        r = got["residual"]["sp"]
        assert r["seq"] == [[]], r
        if "-dpom" in case:       # 4 rows over data and model
            assert r["shapes"] == [[1, SEQ, 64]], r
        else:
            assert r["shapes"] == [[BATCH // mesh["data"], 30, 64]], r


@pytest.mark.parametrize("case", PREFILL_IDS)
def test_sp_prefill_logits_match_single_process_and_reference(ranks, case):
    res, logits, ref = ranks
    want = ref[case]
    single = logits[f"{case}//single"]
    vocab = want.shape[-1]
    assert _rel(single[..., :vocab], want) <= TOL, case
    for act in ("sp", "dp"):
        mesh = logits[f"{case}//{act}"]
        assert mesh.shape == single.shape, (act, mesh.shape)
        assert _rel(mesh, single) <= TOL, (case, act)
        assert _rel(mesh[..., :vocab], want) <= TOL, (case, act)
    m = _mesh(case)
    rows = BATCH // m["data"]
    for got in res[case]:
        assert got["sp"]["shapes"] == [[rows, PROMPT // m["model"], 64]]
        assert got["sp"]["seq"] == [["model"]], got
        assert got["dp"]["shapes"] == [[rows, PROMPT, 64]], got
        assert got["sp"]["hidden"] == got["dp"]["hidden"] == [rows, 1, 64]


def test_mesh_sp_workers_import_no_jax(ranks):
    assert ranks[0]["jax_loaded"] is False


def test_seq_axes_follow_the_reference_constraint():
    """``seq_axes`` is `model` exactly where the reference's
    ``make_shard_act`` puts the sequence on it: ``act_sharding="sp"``,
    no ``dp_over_model``, `model` dividing S; never for an
    encoder-decoder."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.sharding import seq_axes

    mesh = ShapeMesh({"data": 2, "model": 4})
    cfg = get_config("chameleon_34b", smoke=True)
    assert cfg.act_sharding == "sp"
    assert seq_axes(mesh, cfg, 32) == ("model",)
    assert seq_axes(mesh, cfg, 30) == ()
    assert seq_axes(mesh, cfg, 1) == ()
    assert seq_axes(mesh, dataclasses.replace(cfg, act_sharding="dp"),
                    32) == ()
    assert seq_axes(mesh, dataclasses.replace(cfg, dp_over_model=True),
                    32) == ()
    assert seq_axes(ShapeMesh({"data": 8, "model": 1}), cfg, 32) == ()
    assert seq_axes(mesh, dataclasses.replace(
        get_config("whisper_tiny", smoke=True), act_sharding="sp"), 32) == ()
    for arch in ARCHS:
        assert get_config(arch).act_sharding == "sp", arch


def test_sequence_collectives_are_identities_on_one_rank():
    """On a 1 × 1 mesh the sequence gather and reduce-scatter run no
    collective (the stand-in has no process group): a block's entry and
    exit are the identity in value and gradient."""
    import torch

    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models import shard_ctx as S

    mesh = ShapeMesh({"data": 1, "model": 1})
    x = torch.arange(24.0).reshape(1, 4, 6).requires_grad_(True)
    S.set_sharding_context(mesh, ("data",), tp=("model",), seq=("model",))
    try:
        assert S.seq_split() is None
        y = S.leave_block(S.enter_block(x, True) * 2, True)
        y = S.leave_block(S.enter_block(y, False), False)
        y.sum().backward()
    finally:
        S.clear_sharding_context()
    assert torch.equal(y, x * 2) and torch.equal(x.grad,
                                                 torch.full_like(x, 2.0))

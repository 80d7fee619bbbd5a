"""The port's mesh prefill and decode on gloo ranks against its single
process and the JAX package.

``tests/torch_mesh_serve_worker.py`` runs as 4 processes in one gloo
group (a ``FileStore`` rendezvous in ``tmp_path``, joined with a
timeout); the children import no jax.  The weights are the JAX package's
(``init_model(PRNGKey(0))`` at smoke size, MoE at capacity factor 8),
carried by ``convert.lm_params``.  Every case runs ``prefill`` of 4 × 8
tokens into a 16-deep cache, then 4 ``decode_step``s (the second at
per-row positions), single-process and on the mesh from each rank's
shards:

* all eight attention/MLP/MoE architectures on (data, model) = (2, 2),
  where every smoke config's kv heads divide `model` (head-parallel);
* llama3_2_1b and gemma2_2b on (1, 4), where the kv heads (2) do not:
  the caches split on head_dim;
* llama3_2_1b on (pod, data, model) = (2, 1, 2).

Each step's logits, the vocab gathered here, are within 1e-4 of the
largest of both the single-process port's and the JAX package's
``prefill`` / ``decode_step`` + ``logits_fn``; every rank's state is its
block of the single-process state (within 1e-5 of the largest: the
splits sum in another order); the mesh writes the state in place and the
single process leaves its state untouched.
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
from repro.models import decode_step as jdecode_step
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_model as jinit_model
from repro.models import prefill as jprefill
from repro.models.layers import logits_fn as jlogits_fn

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_mesh_serve_worker.py")
JOIN_TIMEOUT = 300
WORLD = 4
TOL = 1e-4
STATE_TOL = 1e-5
B, S, MAX_LEN, STEPS = 4, 8, 16, 4
ARCHS = ("llama3_2_1b", "yi_6b", "gemma2_2b", "phi3_mini_3_8b",
         "chameleon_34b", "moonshot_v1_16b_a3b", "grok_1_314b",
         "whisper_tiny")
MESHES = {"dm22": {"data": 2, "model": 2}, "dm14": {"data": 1, "model": 4},
          "pdm212": {"pod": 2, "data": 1, "model": 2}}
CASES = ([(a, "dm22") for a in ARCHS]
         + [("llama3_2_1b", "dm14"), ("gemma2_2b", "dm14"),
            ("llama3_2_1b", "pdm212")])
CASE_IDS = [f"{a}-{m}" for a, m in CASES]


def jconfig(arch):
    cfg = jget_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def _save_tree(path, tree) -> None:
    flat = {"//".join(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(path, **flat)


def _inputs(arch, cfg) -> dict:
    rng = np.random.default_rng(sum(map(ord, arch)))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "max_len": np.int64(MAX_LEN)}
    if cfg.family == "encdec":
        out["enc_frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    for i in range(STEPS):
        out[f"step{i}_tokens"] = rng.integers(0, cfg.vocab_size, (B, 1))
        out[f"step{i}_pos"] = (np.array([S + i, S + i - 3, S + i - 1, S])
                               if i == 1 else np.int64(S + i))
    return out


def _reference(jp, cfg, inp) -> list:
    """The JAX package's logits of the prefill and every decode step."""
    batch = {"tokens": jnp.asarray(inp["tokens"])}
    enc = 0
    if cfg.family == "encdec":
        batch["enc_frames"] = jnp.asarray(inp["enc_frames"])
        enc = S
    st = jinit_decode_state(cfg, B, MAX_LEN, jnp.float32, enc_len=enc)
    h, st = jprefill(jp, batch, cfg, st)
    out = [np.asarray(jlogits_fn(jp["head"], jp["embed"], h, cfg))]
    for i in range(STEPS):
        h, st = jdecode_step(jp, jnp.asarray(inp[f"step{i}_tokens"]), cfg,
                             st, jnp.asarray(inp[f"step{i}_pos"]))
        out.append(np.asarray(jlogits_fn(jp["head"], jp["embed"], h, cfg)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The workers' results, the logits they wrote, and the JAX package's
    (computed here while the workers run)."""
    d = tmp_path_factory.mktemp("mesh_serve")
    in_dir, out_dir = d / "in", d / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    inputs, params = {}, {}
    for arch in ARCHS:
        cfg = jconfig(arch)
        params[arch] = jinit_model(jax.random.PRNGKey(0), cfg)
        _save_tree(in_dir / f"{arch}_params.npz", params[arch])
        inputs[arch] = _inputs(arch, cfg)
    np.savez(in_dir / "inputs.npz", **{f"{a}//{k}": v for a, inp in
                                       inputs.items() for k, v in
                                       inp.items()})
    (in_dir / "cases.json").write_text(json.dumps(
        [{"name": n, "arch": a, "mesh": MESHES[m]}
         for n, (a, m) in zip(CASE_IDS, CASES)]))
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
        ref = {a: _reference(params[a], jconfig(a), inputs[a])
               for a in ARCHS}
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


@pytest.mark.parametrize("case", CASE_IDS)
def test_mesh_logits_match_single_process_and_reference(ranks, case):
    res, logits, ref = ranks
    arch = case.split("-")[0]
    assert len(res[case]) == WORLD
    for i, want in enumerate(ref[arch]):
        mesh = logits[f"{case}//mesh//{i}"]
        single = logits[f"{case}//single//{i}"]
        vocab = want.shape[-1]
        assert mesh.shape == single.shape
        assert _rel(mesh, single) <= TOL, (case, i)
        # the padded vocab's tail is the port's and the reference's alike
        assert _rel(mesh[..., :vocab], want) <= TOL, (case, i)
        assert _rel(single[..., :vocab], want) <= TOL, (case, i)


@pytest.mark.parametrize("case", CASE_IDS)
def test_mesh_state_is_each_ranks_block_written_in_place(ranks, case):
    res, _, _ = ranks
    for got in res[case]:
        assert got["state_err"] <= STATE_TOL, (case, got["state_err"])
        assert got["in_place"] and got["input_untouched"], case


@pytest.mark.parametrize("case", ["llama3_2_1b-dm14", "gemma2_2b-dm14"])
def test_head_dim_layout_runs_where_kv_heads_do_not_divide(ranks, case):
    """On (1, 4) the smoke configs' 2 kv heads do not divide `model`: each
    rank's cache holds every kv head's quarter of head_dim (16 / 4)."""
    res, _, _ = ranks
    for got in res[case]:
        assert got["cache_spec"] == ["None", "data", "None", "None",
                                     "model"], got
        assert got["cache_local"] == [2, 4], got


def test_head_parallel_layout_on_two_by_two(ranks):
    res, _, _ = ranks
    for got in res["llama3_2_1b-dm22"]:
        assert got["cache_spec"] == ["None", "data", "None", "model",
                                     "None"], got
        assert got["cache_local"] == [1, 16], got


def test_mesh_serve_workers_import_no_jax(ranks):
    assert ranks[0]["jax_loaded"] is False


def test_serve_gather_rules_keep_aligned_model_shards():
    """At |model| = 16: llama's q heads (32) divide `model` and stay split,
    its kv heads (8) do not, so ``w_k``/``w_v`` keep their 32-column
    blocks (each cuts a kv head in half: the layer gathers k and v);
    gemma2's 8 q heads do not divide `model`, so its attention is
    gathered; the MLP, embedding and the experts keep their shards;
    grok's experts keep d_ff's; moonshot's fsdp axis is gathered."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import abstract_params
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.launch.sharding import param_specs, serve_gather_rules

    mesh = production_mesh_shape()
    want = {"llama3_2_1b": {"w_q": ("model",), "w_o": ("model",),
                            "w_k": ("model",), "w_v": ("model",),
                            "w_gate": ("model",),
                            "w_down": ("model",), "embedding": ("model",)},
            "gemma2_2b": {"w_q": (), "w_o": (), "w_k": ()},
            "moonshot_v1_16b_a3b": {"w_q": ("model",), "w_k": ("model",),
                                    "we_gate": ("model",), "router": ()},
            "grok_1_314b": {"we_up": ("model",), "we_down": ("model",),
                            "w_head": ("model",)}}
    for arch, leaves in want.items():
        cfg = get_config(arch)
        params = abstract_params(cfg)
        rules = serve_gather_rules(param_specs(params, mesh, cfg), mesh,
                                   cfg)
        unit = rules["units"]["b0"]
        flat = {**unit["mixer"], **unit["ffn"], **rules["embed"],
                **rules["head"]}
        for name, keep in leaves.items():
            spec, partial, got = flat[name]
            assert (got, partial) == (keep, ()), (arch, name, got)
        if arch == "moonshot_v1_16b_a3b":            # fsdp: gathered
            assert unit["mixer"]["w_q"][0] == ("data", "model")

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

* all ten architectures on (data, model) = (2, 2), where every smoke
  config's kv heads divide `model` (head-parallel), rwkv6_7b's 4 heads
  split 2 a rank and jamba's d_inner 128 splits 64 a rank;
* llama3_2_1b and gemma2_2b on (1, 4), where the kv heads (2) do not:
  the caches split on head_dim; rwkv6_7b and jamba there too (1 head,
  32 channels of d_inner a rank);
* llama3_2_1b on (pod, data, model) = (2, 1, 2);
* jamba's context-parallel decode (``state_specs(...,
  context_parallel=True)``): 1 row into a 64-deep cache whose sequence
  splits over `data`, on (2, 2) and (4, 1), the prompt 8 tokens (every
  decode position in the first data block) or 56 (in the last), and on
  (2, 2) with 1 kv head, whose cache splits on head_dim as well (the
  score sum over `model` and the block merge over `data` composed).

Each step's logits, the vocab gathered here, are within 1e-4 of the
largest of both the single-process port's and the JAX package's
``prefill`` / ``decode_step`` + ``logits_fn``; every rank's state is its
block of the single-process state (within 1e-5 of the largest: the
splits sum in another order); the mesh writes the state in place and the
single process leaves its state untouched.
"""

import dataclasses
import functools
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
STEPS = 4
ARCHS = ("llama3_2_1b", "yi_6b", "gemma2_2b", "phi3_mini_3_8b",
         "chameleon_34b", "moonshot_v1_16b_a3b", "grok_1_314b",
         "whisper_tiny", "rwkv6_7b", "jamba_1_5_large_398b")
RECURRENT = ("rwkv6_7b", "jamba_1_5_large_398b")
JAMBA = "jamba_1_5_large_398b"
MESHES = {"dm22": {"data": 2, "model": 2}, "dm14": {"data": 1, "model": 4},
          "pdm212": {"pod": 2, "data": 1, "model": 2},
          "dm41": {"data": 4, "model": 1}}
# (batch, prompt, cache depth) of each input set
DIMS = {"base": (4, 8, 16), "cp8": (1, 8, 64), "cp56": (1, 56, 64)}
# the weights of each model id: (arch, config replaced)
MODELS = {**{a: (a, {}) for a in ARCHS},
          "jamba_kv1": (JAMBA, {"n_kv_heads": 1})}
# (model, mesh, inputs, context parallel)
CASES = ([(a, "dm22", "base", False) for a in ARCHS]
         + [(a, "dm14", "base", False) for a in
            ("llama3_2_1b", "gemma2_2b") + RECURRENT]
         + [("llama3_2_1b", "pdm212", "base", False)]
         + [(JAMBA, m, i, True) for m in ("dm22", "dm41")
            for i in ("cp8", "cp56")]
         + [("jamba_kv1", "dm22", "cp56", True)])
CASE_IDS = [f"{mod}-{m}" + (f"-{i}" if cp else "")
            for mod, m, i, cp in CASES]
CP_IDS = [c for c in CASE_IDS if "-cp" in c]


def jconfig(arch, replace=None):
    cfg = jget_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return dataclasses.replace(cfg, **(replace or {}))


def _save_tree(path, tree) -> None:
    flat = {"//".join(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(path, **flat)


def _inputs(arch, cfg, dims) -> dict:
    b, s, max_len = DIMS[dims]
    rng = np.random.default_rng(sum(map(ord, arch if dims == "base"
                                        else arch + dims)))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
           "max_len": np.int64(max_len)}
    if cfg.family == "encdec":
        out["enc_frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    for i in range(STEPS):
        out[f"step{i}_tokens"] = rng.integers(0, cfg.vocab_size, (b, 1))
        out[f"step{i}_pos"] = (
            np.array([s + i, s + i - 3, s + i - 1, s][:b]) if i == 1
            else np.int64(s + i))
    return out


@functools.lru_cache(maxsize=None)
def _jitted(cfg):
    """The JAX package's prefill and decode step of ``cfg``, compiled once
    for every case that shares the config (eager, each call of a
    recurrent family retraces its scans)."""
    return (jax.jit(lambda p, b, st: jprefill(p, b, cfg, st)),
            jax.jit(lambda p, t, st, pos: jdecode_step(p, t, cfg, st, pos)))


def _reference(jp, cfg, inp) -> list:
    """The JAX package's logits of the prefill and every decode step."""
    jit_prefill, jit_decode = _jitted(cfg)
    b, s = inp["tokens"].shape
    batch = {"tokens": jnp.asarray(inp["tokens"])}
    enc = 0
    if cfg.family == "encdec":
        batch["enc_frames"] = jnp.asarray(inp["enc_frames"])
        enc = s
    st = jinit_decode_state(cfg, b, int(inp["max_len"]), jnp.float32,
                            enc_len=enc)
    h, st = jit_prefill(jp, batch, st)
    out = [np.asarray(jlogits_fn(jp["head"], jp["embed"], h, cfg))]
    for i in range(STEPS):
        h, st = jit_decode(jp, jnp.asarray(inp[f"step{i}_tokens"]), st,
                           jnp.asarray(inp[f"step{i}_pos"]))
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
    for mod, (arch, rep) in MODELS.items():
        params[mod] = jinit_model(jax.random.PRNGKey(0), jconfig(arch, rep))
        _save_tree(in_dir / f"{mod}_params.npz", params[mod])
    for mod, _, dims, _ in CASES:
        arch, rep = MODELS[mod]
        inputs[mod, dims] = _inputs(arch, jconfig(arch, rep), dims)
    np.savez(in_dir / "inputs.npz", **{
        f"{n}//{k}": v for n, (mod, _, dims, _) in zip(CASE_IDS, CASES)
        for k, v in inputs[mod, dims].items()})
    (in_dir / "cases.json").write_text(json.dumps(
        [{"name": n, "arch": MODELS[mod][0], "model": mod,
          "replace": MODELS[mod][1], "mesh": MESHES[m],
          "context_parallel": cp}
         for n, (mod, m, _, cp) in zip(CASE_IDS, CASES)]))
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
        ref = {key: _reference(params[key[0]], jconfig(*MODELS[key[0]]),
                               inp) for key, inp in inputs.items()}
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
    mod, _, dims, _ = CASES[CASE_IDS.index(case)]
    assert len(res[case]) == WORLD
    for i, want in enumerate(ref[mod, dims]):
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


@pytest.mark.parametrize("mesh", ["dm22", "dm14"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_state_splits_over_model(ranks, arch, mesh):
    """rwkv6_7b's WKV state holds the rank's heads (4 on 2 or 4 ranks),
    jamba's conv and SSM states the rank's channels of d_inner (128 on
    2 or 4 ranks); the shifted tokens stay whole."""
    res, _, _ = ranks
    m = MESHES[mesh]["model"]
    for got in res[f"{arch}-{mesh}"]:
        if arch == "rwkv6_7b":
            assert got["wkv_spec"] == ["None", "data", "model", "None",
                                       "None"], got
            assert got["wkv_local"][2] == 4 // m, got
            assert got["x_prev_tm_local"][-1] == 64, got
        else:
            assert got["conv_spec"] == ["None", "data", "None", "model"]
            assert got["ssm_spec"] == ["None", "data", "model", "None"]
            assert got["conv_local"][-1] == got["ssm_local"][2] == \
                128 // m, got


@pytest.mark.parametrize("case", CP_IDS)
def test_context_parallel_cache_splits_sequence_over_data(ranks, case):
    """One row: the batch cannot split, so the caches' 64 positions do,
    over `data` (32 or 16 a rank), and every data rank runs the row; the
    kv heads over `model` (2 on 2), or with 1 kv head head_dim (8 of
    16)."""
    res, _, _ = ranks
    mod, mesh, _, _ = CASES[CASE_IDS.index(case)]
    d, m = MESHES[mesh]["data"], MESHES[mesh]["model"]
    kv1 = mod == "jamba_kv1"
    want = ["None", "None", "data"] + (["None", "model"] if kv1
                                       else ["model", "None"])
    for got in res[case]:
        assert got["k_spec"] == want, got
        assert got["k_local"][2] == 64 // d, got
        assert got["cache_local"] == ([1, 16 // m] if kv1
                                      else [2 // m, 16]), got


def test_mesh_serve_workers_import_no_jax(ranks):
    assert ranks[0]["jax_loaded"] is False


def test_serve_gather_rules_keep_aligned_model_shards():
    """At |model| = 16: llama's q heads (32) divide `model` and stay split,
    its kv heads (8) do not, so ``w_k``/``w_v`` keep their 32-column
    blocks (each cuts a kv head in half: the layer gathers k and v);
    gemma2's 8 q heads do not divide `model`, so its attention is
    gathered; the MLP, embedding and the experts keep their shards;
    grok's experts keep d_ff's; moonshot's fsdp axis is gathered;
    rwkv6's 64 heads and jamba's d_inner (16,384) split too, and no
    leaf's gradient is summed (forward only)."""
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
                            "w_head": ("model",)},
            "rwkv6_7b": {"w_g": ("model",), "w_o": ("model",),
                         "bonus_u": ("model",), "w_k": ("model",),
                         "decay_base": (), "lora_a": ()},
            "jamba_1_5_large_398b": {"in_proj": ("model",),
                                     "x_proj": ("model",),
                                     "out_proj": ("model",),
                                     "A_log": ("model",)}}
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

"""The port's mesh layer on gloo ranks against the JAX package — mirrors
``tests/test_sharding.py``'s sharded step and distributed MoE, and adds
the checks it leaves out.

``tests/torch_mesh_worker.py`` runs as 8 and as 4 processes in a gloo
group (a ``FileStore`` rendezvous in ``tmp_path``, each spawn joined with
a timeout); the children import no jax.  Their inputs come from the JAX
package: the smoke configs' initial weights (``init_model(PRNGKey(0))``,
carried by ``convert.train_state``), a reference-written checkpoint, and —
from one jax subprocess with 8 host devices — each device's
``NamedSharding.devices_indices_map`` block and the reference's
``_apply_moe_dist`` outputs.

* shards: on (pod, data, model) = (2, 2, 2) and (data, model) = (2, 4),
  every rank's block of every param and moment leaf (llama3_2_1b,
  moonshot and jamba smoke, fsdp on) is the block the reference gives the
  device at the same mesh coordinate;
* train step: llama3_2_1b on (2, 4) and moonshot (fsdp on) on (2, 2), two
  steps: losses within the reference test's 2e-3 of the reference's
  single-device step, and the gathered weights within the CPU train tests'
  bound (1 % of lr) of the port's single-device step.  Moonshot runs at
  capacity factor 8: with drops the distributed MoE's per-shard capacity
  drops other tokens than one device's, as the reference's does;
* MoE on (2, 4): at capacity 8 within the reference test's 2e-4 of the
  local path (aux 1e-4; the input's and every weight's gradient 1e-5 of
  the largest); at the default capacity (drops) and in grok's ffn mode
  within 1e-5 of the reference's distributed output;
* the global norm of a sharded tree counts each element once (a
  replicated leaf, leaves sharded over one axis or both);
* elastic restore: saved on (2, 2), restored onto (4, 1) and onto one
  process with no mesh, and a reference checkpoint onto (2, 2), bit for
  bit;
* the CLI with ``--data-par 2 --model-par 2`` on 4 ranks against one
  process.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import init_model as jinit_model
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.data import SyntheticTokenDataset

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_mesh_worker.py")
JOIN_TIMEOUT = 300
LR = 1e-3

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np, dataclasses
from repro.compat import make_mesh
from repro.configs import get_config
from repro.launch.mesh import batch_axes
from repro.launch.sharding import param_shardings
from repro.models import init_model
from repro.models.moe import apply_moe, init_moe
from repro.models.shard_ctx import set_sharding_context

out = sys.argv[1]
idx = {}
for arch in ("llama3_2_1b", "moonshot_v1_16b_a3b", "jamba_1_5_large_398b"):
    cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=True)
    p = jax.eval_shape(lambda: init_model(jax.random.PRNGKey(0), cfg))
    for mname, shape, axes in (("pdm", (2, 2, 2), ("pod", "data", "model")),
                               ("dm", (2, 4), ("data", "model"))):
        mesh = make_mesh(shape, axes)
        sh = param_shardings(p, mesh, cfg)
        rec = {}
        for (path, leaf), s in zip(jax.tree_util.tree_flatten_with_path(p)[0],
                                   jax.tree.leaves(sh)):
            m = s.devices_indices_map(leaf.shape)
            key = "//".join(k.key for k in path)
            rec[key] = {",".join(map(str, c)): [
                [sl.start or 0, leaf.shape[d] if sl.stop is None else sl.stop]
                for d, sl in enumerate(m[mesh.devices[c]])]
                for c in np.ndindex(mesh.devices.shape)}
        idx[f"{arch}/{mname}"] = rec
json.dump(idx, open(out + "/indices.json", "w"))

mesh = make_mesh((2, 4), ("data", "model"))
arrays = {}
for arch, tag in (("moonshot_v1_16b_a3b", "moonshot"),
                  ("grok_1_314b", "grok")):
    cfg = get_config(arch, smoke=True)
    p = init_moe(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, cfg.d_model),
                          jnp.float32)
    set_sharding_context(mesh, batch_axes(mesh))
    y, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg))(p, x)
    for k, v in p.items():
        arrays[f"{tag}_{k}"] = np.asarray(v)
    arrays.update({f"{tag}_x": np.asarray(x), f"{tag}_y": np.asarray(y),
                   f"{tag}_aux": np.asarray(aux)})
np.savez(out + "/moe.npz", **arrays)
"""


def _save_tree(path, tree) -> None:
    flat = {"//".join(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(path, **flat)


def _batches(vocab):
    ds = SyntheticTokenDataset(vocab, 32, 4, seed=5)
    return [ds.train_inputs(i) for i in range(2)]


def _reference_losses(jcfg, jp) -> list:
    step = jax.jit(jmake_train_step(jcfg, JOptimizerConfig(
        lr=LR, warmup_steps=1, total_steps=10)))
    st, out = jinit_train_state(jp, jcfg), []
    for b in _batches(jcfg.vocab_size):
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The workers' inputs, and the reference's single-device losses."""
    d = tmp_path_factory.mktemp("mesh_in")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          str(d)], capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    losses = {}
    for arch, rep in (("llama3_2_1b", {}),
                      ("moonshot_v1_16b_a3b",
                       {"fsdp": True, "capacity_factor": 8.0})):
        jcfg = dataclasses.replace(jget_config(arch, smoke=True), **rep)
        jp = jinit_model(jax.random.PRNGKey(0), jcfg)
        _save_tree(d / f"{arch}_params.npz", jp)
        losses[arch] = _reference_losses(jcfg, jp)
    # a checkpoint the reference wrote: llama3_2_1b smoke after one step
    jcfg = jget_config("llama3_2_1b", smoke=True)
    st = jinit_train_state(jinit_model(jax.random.PRNGKey(2), jcfg), jcfg)
    b = _batches(jcfg.vocab_size)[0]
    st, _ = jax.jit(jmake_train_step(jcfg, JOptimizerConfig()))(
        st, {k: jnp.asarray(v) for k, v in b.items()})
    JCheckpointManager(str(d / "ref_ckpt")).save(1, st)
    return d, losses


def run_ranks(scenario: str, world: int, tmp: Path, in_dir: Path) -> dict:
    """Run ``world`` worker processes of ``scenario`` in one gloo group;
    the numbers rank 0 wrote.  A hang fails here after the join timeout
    (every process killed)."""
    store, out = tmp / "store", tmp / "out.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), scenario, str(r), str(world),
         str(store), str(out), str(in_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.monotonic() + JOIN_TIMEOUT
    errors = []
    try:
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
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def ranks8(inputs, tmp_path_factory):
    return run_ranks("shards,step_llama,moe", 8,
                     tmp_path_factory.mktemp("mesh8"), inputs[0])


@pytest.fixture(scope="module")
def ranks4(inputs, tmp_path_factory):
    return run_ranks("step_moonshot,norm,restore,cli", 4,
                     tmp_path_factory.mktemp("mesh4"), inputs[0])


@pytest.mark.parametrize("arch", ["llama3_2_1b", "moonshot_v1_16b_a3b",
                                  "jamba_1_5_large_398b"])
@pytest.mark.parametrize("mesh", ["pdm", "dm"])
def test_shards_match_reference_blocks(ranks8, inputs, arch, mesh):
    """Every rank's block of every param, m and v leaf is the one the
    reference's ``devices_indices_map`` gives the device at its mesh
    coordinate; DTensor reads the same full leaf back."""
    ref = json.loads((inputs[0] / "indices.json").read_text())[
        f"{arch}/{mesh}"]
    per_rank = ranks8[f"shards/{arch}/{mesh}"]
    assert len(per_rank) == 8 and not ranks8["jax_loaded"]
    sharded = 0
    for mine in per_rank:
        coord = ",".join(map(str, mine["coord"]))
        for key, blocks in ref.items():
            for tree in ("params", "m", "v"):
                got = mine[f"{tree}//{key}"]
                assert got["block"] == blocks[coord], (tree, key, coord)
                assert got["same"] and got["full"], (tree, key, coord)
            sharded += blocks[coord] != blocks["0," * (len(mine["coord"])
                                                       - 1) + "0"]
    assert sharded > 0


def _check_step(res, tag, ref_losses):
    rows = res[f"{tag}/metrics"]
    for (r, row) in zip(ref_losses, rows):
        single, sharded = row["loss"]
        assert abs(sharded - r) <= 2e-3, (tag, r, row)
        assert abs(sharded - single) <= 1e-5 * abs(single), (tag, row)
        g1, g2 = row["grad_norm"]
        assert abs(g1 - g2) <= 1e-4 * g1, (tag, row)
    # AdamW moves a weight by about lr a step whatever its gradient's size:
    # the sharded sums' last digits show in the weights within 1 % of lr
    assert res[f"{tag}/weights"] <= 0.01 * LR, res[f"{tag}/weights"]
    assert res[f"{tag}/steps"] == [2, 2]


def test_sharded_step_llama_matches_single_device(ranks8, inputs):
    _check_step(ranks8, "step_llama", inputs[1]["llama3_2_1b"])


def test_sharded_step_moonshot_matches_single_device(ranks4, inputs):
    _check_step(ranks4, "step_moonshot", inputs[1]["moonshot_v1_16b_a3b"])


@pytest.mark.parametrize("tag", ["moonshot", "grok"])
def test_dist_moe_matches_reference_and_local(ranks8, tag):
    res = {k.split("/")[-1]: v for k, v in ranks8.items()
           if k.startswith(f"moe/{tag}/")}
    split, n, a2a = res["split"]
    if tag == "moonshot":          # tokens over both axes, experts over model
        assert (split, n, a2a) == (["data", "model"], 8, True)
    else:                          # ffn mode: tokens over data only
        assert (split, n, a2a) == (["data"], 2, False)
    assert res["vs_ref"] <= 1e-5 and res["aux_vs_ref"] <= 1e-5, res
    assert res["vs_local"] <= 2e-4 and res["aux_vs_local"] <= 1e-4, res
    assert res["xgrad_vs_local"] <= 1e-5, res
    assert res["wgrad_vs_local"] <= 1e-5, res


def test_global_norm_counts_each_element_once(ranks4):
    """A replicated leaf and leaves sharded over `data`, `model` or both:
    the sharded tree's norm is the full tree's, and the clipped shards are
    the full clip's blocks."""
    assert ranks4["norm/rel"] <= 1e-6, ranks4["norm/rel"]
    assert ranks4["norm/clipped_blocks"] <= 1e-7


def test_elastic_restore_bit_for_bit(ranks4):
    assert ranks4["restore/onto_4x1"]
    assert ranks4["restore/placed_4x1"] == "(Shard(dim=1), Shard(dim=0))"
    assert ranks4["restore/no_mesh"]
    assert ranks4["restore/dtype"] == "torch.bfloat16"
    assert ranks4["restore/reference"]


def test_cli_on_four_ranks_matches_one_process(ranks4, tmp_path):
    from repro_torch.launch import train as cli

    hist = cli.main(["--arch", "llama3_2_1b", "--smoke", "--steps", "3",
                     "--global-batch", "4", "--seq-len", "32", "--device",
                     "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    one = [h["loss"] for h in hist]
    assert len(ranks4["cli/loss"]) == 3
    for a, b in zip(ranks4["cli/loss"], one):
        assert abs(a - b) <= 1e-5 * abs(b), (ranks4["cli/loss"], one)

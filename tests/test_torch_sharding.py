"""``repro_torch.launch`` against ``repro.launch`` — the sharding rules, the
production meshes and the dry run, from shapes alone.

The reference's specs and shard sizes come from one jax subprocess with
512 host devices (``--xla_force_host_platform_device_count``, the pattern
of ``tests/test_sharding.py::run_with_devices``): every param, train-state,
decode-state (each non-train shape the architecture runs; ``long_500k``
context-parallel) and batch leaf of all ten architectures at full width,
on both production meshes, in four config variants (as published,
``dp_over_model``, ``fsdp=False``, ``moe_sharding="ffn"``), and for every
dry-run cell the sum of ``NamedSharding.shard_shape`` bytes of the step's
arguments as the reference's ``build_cell`` builds them.  The port holds
every spec equal entry by entry (0 mismatched leaves, the same leaf set)
and every cell's per-device bytes equal, with its params built as fake
tensors (nothing allocated).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, ShapeMesh, axis_size,
                                     batch_axes, production_mesh_shape)
from repro_torch.launch.sharding import (_spec_for, batch_specs,
                                         param_shardings, param_specs,
                                         placements, state_specs,
                                         train_state_specs)
from repro_torch.models import init_decode_state, init_model
from repro_torch.train import init_train_state

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"base": {}, "dp_over_model": {"dp_over_model": True},
            "fsdp_off": {"fsdp": False}, "ffn": {"moe_sharding": "ffn"}}

REFERENCE = """
import json, sys, dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.data.pipeline import make_batch_specs
from repro.launch.mesh import make_production_mesh
from repro.launch.sharding import (batch_shardings, param_shardings,
                                   state_shardings, train_state_shardings)
from repro.models import init_decode_state, init_model
from repro.train import init_train_state

VARIANTS = %r
IS_NS = lambda x: isinstance(x, NamedSharding)

def key(path):
    return "//".join(str(getattr(p, "key", getattr(p, "name",
                     getattr(p, "idx", p)))) for p in path)

def flat_specs(tree):
    return {key(p): [list(e) if isinstance(e, tuple) else e for e in s.spec]
            for p, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=IS_NS)[0]}

def shard_bytes(tree, shardings):
    return sum(int(np.prod(s.shard_shape(l.shape)))
               * jnp.dtype(l.dtype).itemsize for l, s in zip(
                   jax.tree.leaves(tree),
                   jax.tree.leaves(shardings, is_leaf=IS_NS)))

def batch_of(cfg, sh):
    if sh.kind == "train":
        return make_batch_specs(cfg, sh)
    b = {"tokens": jax.ShapeDtypeStruct(
        (sh.global_batch, sh.seq_len if sh.kind == "prefill" else 1),
        jnp.int32)}
    if sh.kind == "prefill" and cfg.family == "encdec":
        b["enc_frames"] = jax.ShapeDtypeStruct(
            (sh.global_batch, sh.seq_len, cfg.d_model), jnp.bfloat16)
    return b

meshes = {"single_pod_16x16": make_production_mesh(multi_pod=False),
          "multi_pod_2x16x16": make_production_mesh(multi_pod=True)}
out = {"specs": {}, "bytes": {}}
for arch in ARCH_IDS:
    cfg0 = get_config(arch)
    p_abs = jax.eval_shape(lambda: init_model(jax.random.PRNGKey(0), cfg0))
    states = {}
    for name in cfg0.shapes:
        sh = SHAPES[name]
        if sh.kind != "train":
            enc = sh.seq_len if cfg0.family == "encdec" else 0
            states[name] = jax.eval_shape(lambda: init_decode_state(
                cfg0, sh.global_batch, sh.seq_len, jnp.bfloat16, enc_len=enc))
    for mname, mesh in meshes.items():
        for vname, rep in VARIANTS.items():
            cfg = dataclasses.replace(cfg0, **rep)
            ts = jax.eval_shape(lambda: init_train_state(p_abs, cfg))
            rec = {"params": flat_specs(param_shardings(p_abs, mesh, cfg)),
                   "train": flat_specs(train_state_shardings(ts, mesh, cfg))}
            for name in cfg.shapes:
                sh = SHAPES[name]
                if sh.kind != "train":
                    rec["state:" + name] = flat_specs(state_shardings(
                        states[name], mesh, cfg, global_batch=sh.global_batch,
                        context_parallel=name == "long_500k"))
                rec["batch:" + name] = flat_specs(batch_shardings(
                    batch_of(cfg, sh), mesh, global_batch=sh.global_batch,
                    cfg=cfg))
            out["specs"][f"{arch}|{mname}|{vname}"] = rec
        cfg = cfg0          # the dry run's arguments (dryrun.build_cell)
        for name in cfg.shapes:
            sh = SHAPES[name]
            b = batch_of(cfg, sh)
            n = shard_bytes(b, batch_shardings(
                b, mesh, global_batch=sh.global_batch, cfg=cfg))
            if sh.kind == "train":
                ts = jax.eval_shape(lambda: init_train_state(p_abs, cfg))
                n += shard_bytes(ts, train_state_shardings(ts, mesh, cfg))
            else:
                pb = jax.tree.map(lambda l: jax.ShapeDtypeStruct(
                    l.shape, jnp.bfloat16 if l.dtype == jnp.float32
                    and l.ndim >= 2 else l.dtype), p_abs)
                st = states[name]
                n += shard_bytes(pb, param_shardings(pb, mesh, cfg))
                n += shard_bytes(st, state_shardings(
                    st, mesh, cfg, global_batch=sh.global_batch,
                    context_parallel=name == "long_500k"))
                n += 4 if sh.kind == "decode" else 0    # pos, replicated
            out["bytes"][f"{arch}|{name}|{mname}"] = n
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> dict:
    out = tmp_path_factory.mktemp("ref") / "specs.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE % (VARIANTS,)),
         str(out)], capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def _norm(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, prefix="") -> dict:
    if hasattr(tree, "_fields") and not isinstance(tree, torch.Size):
        out = {}
        for f in tree._fields:
            out.update(_flat(getattr(tree, f), f"{prefix}{f}//"))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}//"))
        return out
    return {prefix[:-2]: _norm(tree)}


_ABSTRACT = {}


def _abstract(arch):
    """(fake params, fake train state, {shape: fake decode state})."""
    if arch not in _ABSTRACT:
        cfg = get_config(arch)
        def build():
            p = init_model(torch.Generator("cpu").manual_seed(0), cfg,
                           device="cpu")
            return p, init_train_state(p, cfg)

        params, ts = dryrun._fake(build)
        states = {}
        for name in cfg.shapes:
            sh = SHAPES[name]
            if sh.kind != "train":
                enc = sh.seq_len if cfg.family == "encdec" else 0
                states[name] = dryrun._fake(lambda: init_decode_state(
                    cfg, sh.global_batch, sh.seq_len, enc_len=enc,
                    device="cpu"))
        _ABSTRACT[arch] = (params, ts, states)
    return _ABSTRACT[arch]


def _batch(cfg, sh) -> dict:
    if sh.kind == "train":
        return {k: s for k, (s, _) in
                dryrun.make_batch_specs(cfg, sh).items()}
    out = {"tokens": (sh.global_batch,
                      sh.seq_len if sh.kind == "prefill" else 1)}
    if sh.kind == "prefill" and cfg.family == "encdec":
        out["enc_frames"] = (sh.global_batch, sh.seq_len, cfg.d_model)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(reference, arch):
    """Every leaf's spec equals the reference's ``PartitionSpec``, on both
    production meshes and in every variant: params, train state, decode
    states and batches."""
    params, ts, states = _abstract(arch)
    checked = 0
    for mname, shape in PRODUCTION_SHAPES.items():
        mesh = ShapeMesh(shape)
        for vname, rep in VARIANTS.items():
            cfg = dataclasses.replace(get_config(arch), **rep)
            ref = reference["specs"][f"{arch}|{mname}|{vname}"]
            got = {"params": _flat(param_specs(params, mesh, cfg)),
                   "train": _flat(train_state_specs(ts, mesh, cfg))}
            for name in cfg.shapes:
                sh = SHAPES[name]
                if sh.kind != "train":
                    got["state:" + name] = _flat(state_specs(
                        states[name], mesh, cfg,
                        global_batch=sh.global_batch,
                        context_parallel=name == "long_500k"))
                got["batch:" + name] = _flat(batch_specs(
                    _batch(cfg, sh), mesh, global_batch=sh.global_batch,
                    cfg=cfg))
            assert got.keys() == ref.keys()
            for tree, leaves in ref.items():
                assert got[tree].keys() == leaves.keys(), (mname, vname,
                                                           tree)
                bad = {k: (got[tree][k], v) for k, v in leaves.items()
                       if got[tree][k] != v}
                assert not bad, (mname, vname, tree, bad)
                checked += len(leaves)
    assert checked > 100


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_bytes_match_reference(reference, arch, tmp_path,
                                      monkeypatch):
    """Each cell's per-device argument bytes (``memory.argument_bytes``,
    the argument half: ``cost=False``) equal the reference's sum of
    ``shard_shape`` bytes; ``long_500k`` skips on full-attention
    architectures; records land under the output directory."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    cfg = get_config(arch)
    for multi in (False, True):
        for name in SHAPES:
            rec = dryrun.run_cell(arch, name, multi, verbose=False,
                                  device_bytes=80 * 2**30, cost=False)
            key = f"{arch}|{name}|{rec['mesh']}"
            if name not in cfg.shapes:
                assert rec["status"] == "SKIP" and key not in \
                    reference["bytes"]
                continue
            assert rec["status"] == "OK", rec
            args = rec["memory"]["argument_bytes"]
            assert args == reference["bytes"][key], key
            assert rec["fits"] == (args <= 80 * 2**30)
            assert rec["chips"] == (512 if multi else 256)
            assert (tmp_path / rec["mesh"] / f"{arch}__{name}.json").exists()
    n = dryrun.count_params(_abstract(arch)[0])
    assert n == sum(t.numel() for t in
                    dryrun.tree_leaves(_abstract(arch)[0]))


def test_dryrun_cli_counts_cells(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "rwkv6_7b", "--device-bytes",
                        str(2**30), "--args-only"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("dry-run complete: 8 OK, 0 SKIP, 0 FAIL")
    assert dryrun.main(["--arch", "llama3_2_1b", "--mesh", "single",
                        "--args-only"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert "3 OK, 1 SKIP, 0 FAIL" in last


def test_param_rules_divisibility_fallback():
    """KV-head dims that don't divide the model axis must fall back to
    replicated rather than erroring (the reference's test)."""
    cfg = get_config("llama3_2_1b", smoke=True)
    mesh = ShapeMesh({"data": 4, "model": 8})
    spec = _spec_for((6, 64), ("tp", None), mesh, cfg)   # 6 % 8 != 0
    assert spec[0] is None
    spec = _spec_for((64, 64), ("tp", None), mesh, cfg)
    assert spec[0] == "model"


def test_production_meshes_are_shapes_without_a_process_group():
    import torch.distributed as dist

    single = production_mesh_shape()
    multi = production_mesh_shape(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert batch_axes(single) == ("data",)
    assert batch_axes(multi) == ("pod", "data")
    assert axis_size(multi, ("pod", "data")) == 32
    assert axis_size(multi, None) == 1 and axis_size(multi, "model") == 16
    assert not dist.is_initialized()


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = production_mesh_shape(multi_pod=True)
    assert placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert placements((None, None), mesh) == (Replicate(),) * 3
    assert placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        placements((("data", "pod"),), mesh)
    cfg = get_config("llama3_2_1b")
    tree = param_shardings({"units": {"b0": {"mixer": {
        "w_k": torch.empty((16, 2048, 512), device="meta")}}}}, mesh, cfg)
    assert tree["units"]["b0"]["mixer"]["w_k"] == (
        Replicate(), Replicate(), Shard(2))


def test_state_specs_context_parallel_and_fallbacks():
    """The KV cache's heads over `model`, else its head_dim; its sequence
    over `data` only with ``context_parallel``; a batch that does not
    divide the DP axes replicates."""
    cfg = get_config("llama3_2_1b")
    mesh = production_mesh_shape()
    kv = {"b0": {"k": (16, 128, 32768, 8, 64)}}       # 8 heads < 16
    assert state_specs(kv, mesh, cfg, global_batch=128) == {
        "b0": {"k": (None, "data", None, None, "model")}}
    one = {"b0": {"k": (16, 1, 524288, 32, 64)}}
    assert state_specs(one, mesh, cfg, global_batch=1,
                       context_parallel=True) == {
        "b0": {"k": (None, None, "data", "model", None)}}
    assert batch_specs({"tokens": (3, 8)}, mesh, global_batch=3) == {
        "tokens": (None, None)}

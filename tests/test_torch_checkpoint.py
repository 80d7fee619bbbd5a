"""``repro_torch.train.checkpoint`` and ``fault_tolerance``: the five cases
of ``tests/test_checkpoint.py`` on the port, and checkpoints read across
packages — the port restores a reference-written file and the reference
restores the port's (fp32 leaves equal), a bf16 state round-trips bit for
bit, and a reference file's bf16 leaves (``|V2`` on disk) come back as
bf16 in the port."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_model as jinit_model
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import init_train_state as jinit_train_state
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenDataset
from repro_torch.models import init_model
from repro_torch.train import (CheckpointManager, OptimizerConfig,
                               ResilientTrainer, StragglerWatchdog,
                               init_train_state, make_train_step)
from repro_torch.train.checkpoint import _items


def leaves(tree):
    return [leaf for _, leaf in _items(tree)]


def setup_tiny(**replace):
    cfg = get_config("llama3_2_1b", smoke=True)
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
    params = init_model(0, cfg, device="cpu")
    state = init_train_state(params, cfg)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, total_steps=50))
    ds = SyntheticTokenDataset(cfg.vocab_size, 32, 2, seed=3)
    return cfg, state, step, ds.train_inputs


def assert_states_equal(a, b):
    ka, kb = [k for k, _ in _items(a)], [k for k, _ in _items(b)]
    assert ka == kb
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---- mirrors of tests/test_checkpoint.py -----------------------------------

def test_roundtrip_exact(tmp_path):
    cfg, state, step, batch_fn = setup_tiny()
    cm = CheckpointManager(str(tmp_path))
    state, _ = step(state, batch_fn(0))
    cm.save(1, state)
    restored = cm.restore(1, state)
    assert_states_equal(state, restored)


def test_async_save_and_latest(tmp_path):
    cfg, state, step, batch_fn = setup_tiny()
    cm = CheckpointManager(str(tmp_path), keep=2)
    for i in (1, 2, 3):
        cm.save(i, state, blocking=False)
    cm.wait()
    assert cm.latest_step() == 3
    # keep=2 garbage collection
    files = [f for f in os.listdir(tmp_path) if f.startswith("step_")]
    assert len(files) <= 3


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """Train 10 steps straight vs 5 + restore + 5: identical final loss —
    checkpoint + stateless data pipeline give exact resume."""
    cfg, state0, step, batch_fn = setup_tiny()

    s = state0
    for i in range(10):
        s, m = step(s, batch_fn(i))
    loss_straight = float(m["loss"])

    cm = CheckpointManager(str(tmp_path / "b"))
    s = state0
    for i in range(5):
        s, m = step(s, batch_fn(i))
    cm.save(5, s)
    restored = cm.restore(5, s)
    for i in range(5, 10):
        restored, m = step(restored, batch_fn(i))
    assert float(m["loss"]) == pytest.approx(loss_straight, abs=1e-6)


def test_resilient_trainer_survives_injected_failures(tmp_path):
    cfg, state, step, batch_fn = setup_tiny()
    cm = CheckpointManager(str(tmp_path))
    boom = {"left": 2}

    def injector(i):
        if i == 7 and boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("simulated preemption")

    trainer = ResilientTrainer(step_fn=step, batch_fn=batch_fn, ckpt=cm,
                               ckpt_every=3, async_ckpt=False,
                               failure_injector=injector)
    final, history = trainer.run(state, 0, 12)
    assert boom["left"] == 0                       # failures actually fired
    assert history[-1]["step"] == 11
    assert cm.latest_step() is not None


def test_straggler_watchdog_flags_outliers():
    wd = StragglerWatchdog(factor=3.0, min_samples=3)
    for i in range(6):
        wd.observe(i, 0.01)
    wd.observe(6, 0.5)
    assert len(wd.flagged) == 1
    assert wd.flagged[0][0] == 6


# ---- port-only --------------------------------------------------------------

def test_donated_steps_with_async_saves_resume_exactly(tmp_path):
    """In-place steps after a non-blocking save: the snapshot taken on the
    caller's thread is not touched by the next step's update, so the run
    that fails and restores ends where the straight run does."""
    cfg, state0, _, batch_fn = setup_tiny()
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, total_steps=50),
                           donate=True)
    s = init_train_state(init_model(0, cfg, device="cpu"), cfg)
    for i in range(6):
        s, m = step(s, batch_fn(i))
    straight = float(m["loss"])
    fired = []

    def injector(i):
        if i == 5 and not fired:
            fired.append(i)
            raise RuntimeError("simulated preemption")

    cm = CheckpointManager(str(tmp_path))
    trainer = ResilientTrainer(step_fn=step, batch_fn=batch_fn, ckpt=cm,
                               ckpt_every=2, async_ckpt=True,
                               failure_injector=injector)
    s, hist = trainer.run(init_train_state(init_model(0, cfg, device="cpu"),
                                           cfg), 0, 6)
    assert fired == [5] and [h["step"] for h in hist] == [0, 1, 2, 3, 4, 4,
                                                          5]
    assert hist[-1]["loss"] == straight


def _fail_inside_the_update(monkeypatch, at_leaf=3):
    """Make the next AdamW update raise after it has written ``at_leaf - 1``
    leaves (once)."""
    from repro_torch.train import optimizer as opt_mod

    real = opt_mod.tree_map
    armed = [True]

    def tree_map(fn, tree, *rest):
        if fn.__name__ != "upd" or not armed[0]:
            return real(fn, tree, *rest)
        seen = [0]

        def once(*leaves):
            seen[0] += 1
            if seen[0] == at_leaf:
                armed[0] = False
                raise RuntimeError("simulated failure inside the update")
            return fn(*leaves)

        return real(once, tree, *rest)

    monkeypatch.setattr(opt_mod, "tree_map", tree_map)


@pytest.mark.parametrize("in_place", [False, True])
def test_update_that_fails_part_way_says_so(monkeypatch, in_place):
    """A functional update that fails leaves its inputs whole and raises
    the failure as it was; an in-place one has written some leaves, and
    raises ``PartialUpdateError``."""
    from repro_torch.train import (PartialUpdateError, adamw_update,
                                   init_opt_state)

    p = {"a": torch.ones(3, 2), "b": torch.ones(3), "c": torch.ones(2, 2)}
    g = {k: torch.full_like(v, 0.5) for k, v in p.items()}
    before = {k: v.clone() for k, v in p.items()}
    _fail_inside_the_update(monkeypatch)
    want = PartialUpdateError if in_place else RuntimeError
    with pytest.raises(want) as info:
        adamw_update(p, g, init_opt_state(p), OptimizerConfig(),
                     in_place=in_place)
    assert isinstance(info.value, PartialUpdateError) == in_place
    changed = [k for k in p if not torch.equal(p[k], before[k])]
    assert changed == (["a", "b"] if in_place else [])


def test_trainer_retries_a_half_updated_state_only_from_a_checkpoint(
        tmp_path, monkeypatch):
    """A donating step that fails inside its update: with no checkpoint the
    trainer re-raises instead of stepping on from the half-updated state;
    with one it restores it and ends where the straight run does."""
    from repro_torch.train import PartialUpdateError

    cfg, _, _, batch_fn = setup_tiny()
    opt = OptimizerConfig(lr=1e-3, total_steps=50)
    step = make_train_step(cfg, opt, donate=True)

    def fresh():
        return init_train_state(init_model(0, cfg, device="cpu"), cfg)

    s = fresh()
    for i in range(3):
        s, _ = step(s, batch_fn(i))
    straight = s
    no_ckpt = ResilientTrainer(step_fn=step, batch_fn=batch_fn,
                               ckpt=CheckpointManager(str(tmp_path / "a")),
                               ckpt_every=100, async_ckpt=False)
    _fail_inside_the_update(monkeypatch)
    with pytest.raises(PartialUpdateError):
        no_ckpt.run(fresh(), 0, 3)
    assert no_ckpt.ckpt.latest_step() is None
    cm = CheckpointManager(str(tmp_path / "b"))
    s0 = fresh()
    cm.save(0, s0)
    trainer = ResilientTrainer(step_fn=step, batch_fn=batch_fn, ckpt=cm,
                               ckpt_every=100, async_ckpt=False)
    _fail_inside_the_update(monkeypatch)
    s, hist = trainer.run(s0, 0, 3)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert_states_equal(s, straight)


def test_manifest_and_file_layout_match_the_reference(tmp_path):
    """The same files and manifest keys as the reference writes, and the
    keys of a ``TrainState``'s leaves as the reference names them."""
    cfg, state, _, _ = setup_tiny()
    jcfg = jget_config("llama3_2_1b", smoke=True)
    jstate = jinit_train_state(jinit_model(jax.random.PRNGKey(0), jcfg),
                               jcfg)
    CheckpointManager(str(tmp_path / "t")).save(7, state, {"step": 7})
    JCheckpointManager(str(tmp_path / "j")).save(7, jstate, {"step": 7})
    for d in ("t", "j"):
        assert sorted(os.listdir(tmp_path / d)) == ["manifest.json",
                                                    "step_0000000007.npz"]
    mt = json.loads((tmp_path / "t" / "manifest.json").read_text())
    mj = json.loads((tmp_path / "j" / "manifest.json").read_text())
    assert sorted(mt) == sorted(mj) == ["extra", "latest", "saved_at",
                                        "steps"]
    assert (mt["steps"], mt["latest"], mt["extra"]) == (
        mj["steps"], mj["latest"], mj["extra"])
    with np.load(tmp_path / "t" / "step_0000000007.npz") as zt, \
            np.load(tmp_path / "j" / "step_0000000007.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].shape == zj[k].shape and zt[k].dtype == zj[k].dtype
    assert ".params//units//b0//mixer//w_q" in zj.files
    assert ".opt//.m//embed//embedding" in zj.files and ".step" in zj.files


def test_port_restores_a_reference_checkpoint(tmp_path):
    """A reference-written fp32 checkpoint of a trained state, restored
    into the port's template: every leaf equal to the reference's."""
    from repro.train import OptimizerConfig as JOpt
    from repro.train import make_train_step as jmake_train_step

    jcfg = jget_config("llama3_2_1b", smoke=True)
    jstate = jinit_train_state(jinit_model(jax.random.PRNGKey(0), jcfg),
                               jcfg)
    batch = SyntheticTokenDataset(jcfg.vocab_size, 32, 2,
                                  seed=1).train_inputs(0)
    jstate, _ = jax.jit(jmake_train_step(jcfg, JOpt(total_steps=10)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    JCheckpointManager(str(tmp_path)).save(1, jstate)
    tcfg = convert.model_config(jcfg)
    template = init_train_state(init_model(5, tcfg, device="cpu"), tcfg)
    restored = CheckpointManager(str(tmp_path)).restore(1, template)
    want = convert.train_state(jax.tree.map(np.asarray, jstate), tcfg,
                               device="cpu")
    assert_states_equal(restored, want)
    assert int(restored.step) == 1 and int(restored.opt.step) == 1


def test_reference_restores_a_port_checkpoint(tmp_path):
    cfg, state, step, batch_fn = setup_tiny()
    state, _ = step(state, batch_fn(0))
    CheckpointManager(str(tmp_path)).save(1, state)
    jcfg = jget_config("llama3_2_1b", smoke=True)
    jtemplate = jinit_train_state(jinit_model(jax.random.PRNGKey(3), jcfg),
                                  jcfg)
    jrestored = JCheckpointManager(str(tmp_path)).restore(1, jtemplate)
    flat = dict(_items(state))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jrestored)[0]:
        key = "//".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        ours = flat[key]
        np.testing.assert_array_equal(np.asarray(leaf), ours.numpy())
        assert np.asarray(leaf).dtype == ours.numpy().dtype


def test_bf16_state_round_trips_bit_for_bit(tmp_path):
    cfg, state, step, batch_fn = setup_tiny(opt_state_dtype="bfloat16",
                                            dtype="bfloat16")
    state, _ = step(state, batch_fn(0))
    assert state.opt.m["embed"]["embedding"].dtype == torch.bfloat16
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, state)
    template = init_train_state(init_model(9, cfg, device="cpu"), cfg)
    restored = cm.restore(1, template)
    assert_states_equal(state, restored)
    with np.load(tmp_path / "step_0000000001.npz") as z:
        # on disk as the reference writes bf16: two raw bytes an element
        assert z[".opt//.m//embed//embedding"].dtype == np.dtype("V2")


def test_reference_bf16_leaves_read_as_bf16(tmp_path):
    """The reference writes a bf16 state with ``np.savez``; its leaves load
    back as ``|V2`` (and the reference's own restore keeps them so).  The
    port takes the dtype from its template: bf16, bit for bit."""
    jcfg = dataclasses.replace(jget_config("llama3_2_1b", smoke=True),
                               opt_state_dtype="bfloat16")
    jstate = jinit_train_state(jinit_model(jax.random.PRNGKey(0), jcfg),
                               jcfg)
    rng = np.random.default_rng(0)
    jstate = jstate._replace(opt=jstate.opt._replace(m=jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.bfloat16),
        jstate.opt.m)))
    JCheckpointManager(str(tmp_path)).save(2, jstate)
    with np.load(tmp_path / "step_0000000002.npz") as z:
        assert z[".opt//.m//embed//embedding"].dtype == np.dtype("V2")
    jback = JCheckpointManager(str(tmp_path)).restore(2, jstate)
    assert np.asarray(jback.opt.m["embed"]["embedding"]).dtype.kind == "V"
    tcfg = convert.model_config(jcfg)
    template = init_train_state(init_model(1, tcfg, device="cpu"), tcfg)
    restored = CheckpointManager(str(tmp_path)).restore(2, template)
    want = convert.train_state(jax.tree.map(np.asarray, jstate), tcfg,
                               device="cpu")
    assert restored.opt.m["embed"]["embedding"].dtype == torch.bfloat16
    assert_states_equal(restored, want)


def test_restore_checks_keys_and_shapes(tmp_path):
    cfg, state, _, _ = setup_tiny()
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf b"):
        cm.restore(1, {"b": torch.ones(3)})
    with pytest.raises(ValueError, match="shape mismatch at a"):
        cm.restore(1, {"a": torch.ones(4)})
    assert cm.restore_latest({"a": torch.zeros(3)})[0] == 1
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        {"a": torch.zeros(3)}) == (None, None)

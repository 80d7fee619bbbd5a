"""``repro_torch.train`` against ``repro.train`` — the optimizer, the loss
and its gradients, the train step, and fixed-mask value training — plus
mirrors of ``tests/test_train.py``.

Weights and states come from the JAX package (``init_model(PRNGKey(0))``,
``init_train_state``) and are carried into the port by
``convert.lm_params`` / ``convert.train_state``; batches come from the
synthetic pipeline or from numpy with a seed.  Tolerances: the optimizer
1e-6 (relative to the largest entry), the loss and its gradients 1e-5 of
the largest, a 3-step loss trajectory 1e-4, the value steps' losses 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_config as jget_config
from repro.models import init_model as jinit_model
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import adamw_update as jadamw_update
from repro.train import clip_by_global_norm as jclip
from repro.train import init_opt_state as jinit_opt_state
from repro.train import init_train_state as jinit_train_state
from repro.train import lr_at as jlr_at
from repro.train import make_loss_fn as jmake_loss_fn
from repro.train import make_train_step as jmake_train_step
from repro.train.train_step import \
    make_sparse_value_train_step as jmake_value_step
from repro_torch import convert
from repro_torch.api import pruned_linear
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenDataset
from repro_torch.models import init_model
from repro_torch.models.layers import apply_norm
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.train import (OptimizerConfig, adamw_update,
                               clip_by_global_norm, global_norm,
                               init_opt_state, init_train_state, lr_at,
                               make_loss_fn, make_sparse_value_train_step,
                               make_train_step)
from repro_torch.train.train_step import value_and_grad

NEW_FAMILIES = ["grok_1_314b", "rwkv6_7b", "jamba_1_5_large_398b"]


def rel(a, b) -> float:
    """max|a - b| / max|b|."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t2n(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def assert_tree_close(ttree, jtree, tol, what=""):
    """Every leaf of the JAX tree against the port tree's leaf at the same
    path, max|Δ| / max|ref| ≤ tol."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert jflat
    for path, leaf in jflat:
        t = ttree
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == tuple(leaf.shape), path
        ref = np.asarray(leaf, dtype=np.float32)
        if np.abs(ref).max() == 0:
            assert float(t.abs().max()) == 0.0, (what, path)
        else:
            assert rel(t2n(t), ref) <= tol, (what, path, rel(t2n(t), ref))


def assert_params_within(ttree, jtree, atol):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        t = ttree
        for key in path:
            t = t[key.key]
        err = float(np.abs(t2n(t) - np.asarray(leaf)).max())
        assert err <= atol, (path, err)


_SETUPS = {}


def setup(arch, **replace):
    """(jax cfg, jax params, port cfg, port params), memoized."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _SETUPS:
        jcfg = jget_config(arch, smoke=True)
        if replace:
            jcfg = dataclasses.replace(jcfg, **replace)
        jp = jinit_model(jax.random.PRNGKey(0), jcfg)
        tcfg = convert.model_config(jcfg)
        tp = convert.lm_params(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
        _SETUPS[key] = (jcfg, jp, tcfg, tp)
    return _SETUPS[key]


def make_batch(cfg, b=4, s=64, step=0, seed=7) -> dict:
    return SyntheticTokenDataset(cfg.vocab_size, s, b,
                                 seed=seed).train_inputs(step)


def jbatch(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the optimizer against the reference
# ---------------------------------------------------------------------------

def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "blk": {"b": rng.standard_normal(8).astype(np.float32),
                      "m": rng.standard_normal((4, 6, 3)).astype(np.float32)}}
    grads = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32),
        params)
    return params, grads


def _to_t(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_place", [False, True])
def test_adamw_update_matches_jax(state_dtype, in_place):
    """Three AdamW steps on the same params and grads as the reference,
    with moments in fp32 and in bf16, clipping active (norm > 1)."""
    params, grads = _opt_trees()
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
                  clip_norm=1.0)
    jp, jopt = jax.tree.map(jnp.asarray, params), jinit_opt_state(
        jax.tree.map(jnp.asarray, params), getattr(jnp, state_dtype))
    tp = _to_t(params)
    topt = init_opt_state(tp, state_dtype)
    for step in range(3):
        g = jax.tree.map(lambda a: a * (step + 1), grads)
        jp, jopt, jm = jadamw_update(jp, jax.tree.map(jnp.asarray, g), jopt,
                                     JOptimizerConfig(**cfg_kw))
        tp2, topt2, tm = adamw_update(tp, _to_t(g), topt,
                                      OptimizerConfig(**cfg_kw),
                                      in_place=in_place)
        if in_place:        # the state's own tensors were written
            assert all(a is b for a, b in zip(tree_leaves(tp2),
                                              tree_leaves(tp)))
        tp, topt = tp2, topt2
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    assert int(topt.step) == int(jopt.step) == 3
    assert all(l.dtype == getattr(torch, state_dtype)
               for l in tree_leaves(topt.m))
    assert_tree_close(tp, jp, 1e-6, "params")
    assert_tree_close(topt.m, jopt.m, 1e-6 if state_dtype == "float32"
                      else 2 ** -8, "m")
    assert_tree_close(topt.v, jopt.v, 1e-6 if state_dtype == "float32"
                      else 2 ** -8, "v")


def test_lr_at_and_clipping_match_jax():
    opt = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        want = float(jlr_at(JOptimizerConfig(**opt), jnp.int32(s)))
        got = float(lr_at(OptimizerConfig(**opt), s))
        assert abs(got - want) <= 1e-6 * max(want, 1e-12), s
    _, grads = _opt_trees(3)
    for max_norm in (0.5, 1e9):
        jc, jn = jclip(jax.tree.map(jnp.asarray, grads), max_norm)
        tc, tn = clip_by_global_norm(_to_t(grads), max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        assert_tree_close(tc, jc, 1e-6, "clipped")


# ---------------------------------------------------------------------------
# the loss, its gradients and the train step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3_2_1b"] + NEW_FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """``make_loss_fn``'s loss (nll + MoE aux) within 1e-5 and its
    gradients within 1e-5 of the largest, against ``jax.value_and_grad``
    of the reference's loss on the same weights and batch."""
    jcfg, jp, tcfg, tp = setup(arch)
    batch = make_batch(tcfg, b=2, s=32)
    (jl, jx), jg = jax.value_and_grad(jmake_loss_fn(jcfg), has_aux=True)(
        jp, jbatch(batch))
    loss, extras, grads = value_and_grad(make_loss_fn(tcfg), tp, batch)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(extras["moe_aux"]) - float(jx["moe_aux"])) <= 1e-5 * max(
        abs(float(jx["moe_aux"])), 1e-30)
    jleaves = jax.tree.leaves(jg)
    scale = max(float(jnp.abs(g).max()) for g in jleaves)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    for path, leaf in jflat:
        t = grads
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.float32, path
        err = float(np.abs(t2n(t) - np.asarray(leaf)).max()) / scale
        assert err <= 1e-5, (path, err)


def test_three_step_trajectory_matches_jax():
    """Three jitted reference steps and three port steps from the same
    ``TrainState`` (carried by ``convert.train_state``): losses within
    1e-4, and the final params within 1e-4 of the largest."""
    jcfg, jp, tcfg, _ = setup("llama3_2_1b")
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jst = jinit_train_state(jp, jcfg)
    tst = convert.train_state(jax.tree.map(np.asarray, jst), tcfg,
                              device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, JOptimizerConfig(**opt)))
    tstep = make_train_step(tcfg, OptimizerConfig(**opt))
    for i in range(3):
        batch = make_batch(tcfg, b=2, s=32, step=i)
        jst, jm = jstep(jst, jbatch(batch))
        tst, tm = tstep(tst, batch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4 * abs(
            float(jm["loss"])), i
    assert int(tst.step) == 3 and int(tst.opt.step) == 3
    # AdamW moves a weight by about lr a step whatever its gradient's size,
    # so the two packages' last-digit differences in tiny gradients show up
    # in the weights: they must agree within 1 % of one step's move
    assert_params_within(tst.params, jst.params, 0.01 * opt["lr"])


def test_microbatch_step_matches_jax():
    """The accumulation loop against the reference's ``lax.scan``."""
    jcfg, jp, tcfg, _ = setup("llama3_2_1b")
    opt = dict(lr=1e-3, total_steps=10)
    jst = jinit_train_state(jp, jcfg)
    tst = convert.train_state(jax.tree.map(np.asarray, jst), tcfg,
                              device="cpu")
    batch = make_batch(tcfg, b=4, s=32)
    jst, jm = jax.jit(jmake_train_step(jcfg, JOptimizerConfig(**opt),
                                       microbatches=2))(jst, jbatch(batch))
    tst, tm = make_train_step(tcfg, OptimizerConfig(**opt),
                              microbatches=2)(tst, batch)
    # a jitted reference step, as in the trajectory test: 1e-4
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4 * abs(
        float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * \
        float(jm["grad_norm"])
    assert_params_within(tst.params, jst.params, 0.01 * opt["lr"])


# ---------------------------------------------------------------------------
# mirrors of tests/test_train.py
# ---------------------------------------------------------------------------

def _port_state(arch="llama3_2_1b", **replace):
    cfg = get_config(arch, smoke=True)
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
    return cfg, init_train_state(init_model(0, cfg, device="cpu"), cfg)


def test_loss_decreases():
    cfg, state = _port_state()
    step = make_train_step(cfg, OptimizerConfig(lr=1e-2, warmup_steps=2,
                                                total_steps=40))
    batch = make_batch(cfg)
    losses = []
    for _ in range(15):                    # overfit one batch
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_microbatch_equals_full_batch_grads():
    """Grad accumulation must average to the same update (linearity)."""
    cfg, s1 = _port_state()
    s2 = init_train_state(tree_map(torch.clone, s1.params), cfg)
    opt = OptimizerConfig(lr=1e-3, total_steps=10)
    batch = make_batch(cfg, b=4)
    st1, m1 = make_train_step(cfg, opt, microbatches=1)(s1, batch)
    st2, m2 = make_train_step(cfg, opt, microbatches=2)(s2, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(st1.params), tree_leaves(st2.params)))
    assert d < 5e-4


def test_bf16_optimizer_state():
    cfg, state = _port_state(opt_state_dtype="bfloat16")
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(state.opt.m))
    state, metrics = make_train_step(cfg, OptimizerConfig(total_steps=10))(
        state, make_batch(cfg))
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(state.opt.v))


def test_grad_clipping_bounds_update():
    g = {"a": torch.full((8, 8), 100.0), "b": torch.full((4,), -50.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    assert float(global_norm(clipped)) <= 1.0 + 1e-5


def test_lr_schedule_shape():
    opt = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(lr_at(opt, s)) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] < lrs[1] < lrs[2]        # warmup
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[2] > lrs[3] > lrs[4]        # cosine decay
    assert lrs[4] == pytest.approx(0.1, abs=1e-3)


# ---------------------------------------------------------------------------
# port-only: remat, gradient dtypes, in-place steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3_2_1b", "jamba_1_5_large_398b"])
def test_remat_on_and_off_give_the_same_gradients(arch):
    cfg, state = _port_state(arch)
    batch = make_batch(cfg, b=2, s=32)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(make_loss_fn(c), state.params, batch)
    assert float(out[True][0]) == pytest.approx(float(out[False][0]),
                                                rel=1e-6)
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-30)


def test_remat_recomputes_each_unit_in_the_backward(monkeypatch):
    """With ``remat`` the unit body runs twice a unit (forward, and again
    in the backward pass), without it once."""
    from repro_torch.models import transformer

    calls = []
    real = transformer._apply_unit

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(transformer, "_apply_unit", spy)
    cfg, state = _port_state()
    batch = make_batch(cfg, b=2, s=16)
    for remat, want in ((False, cfg.n_units), (True, 2 * cfg.n_units)):
        calls.clear()
        value_and_grad(make_loss_fn(dataclasses.replace(cfg, remat=remat)),
                       state.params, batch)
        assert len(calls) == want, (remat, len(calls))


def test_gradient_dtypes_under_bf16_compute():
    """bf16 compute on fp32 masters: the masters' gradients are fp32 (the
    cast's backward), and the residual stream's gradient stays bf16 through
    a norm — the reference's ``_grad_same_dtype`` boundary, which the
    backward of ``x.float()`` gives in PyTorch."""
    cfg, state = _port_state(dtype="bfloat16")
    batch = make_batch(cfg, b=2, s=16)
    seen = []
    from repro_torch.models import transformer

    real = transformer._apply_unit

    def spy(up, x, *a, **kw):
        if x.requires_grad:
            x.register_hook(lambda g: seen.append(g.dtype))
        return real(up, x, *a, **kw)

    transformer._apply_unit = spy
    try:
        loss, _, grads = value_and_grad(
            make_loss_fn(dataclasses.replace(cfg, remat=False)),
            state.params, batch)
    finally:
        transformer._apply_unit = real
    assert bool(torch.isfinite(loss))
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    assert seen and set(seen) == {torch.bfloat16}
    x = torch.randn(2, 3, cfg.d_model, dtype=torch.bfloat16,
                    requires_grad=True)
    apply_norm(state.params["final_norm"], x, cfg).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16


def test_donated_step_updates_in_place_and_matches():
    cfg, s1 = _port_state()
    s2 = init_train_state(tree_map(torch.clone, s1.params), cfg)
    opt = OptimizerConfig(lr=1e-3, total_steps=10)
    batch = make_batch(cfg, b=2, s=32)
    ptrs = [t.data_ptr() for t in tree_leaves(s2.params)]
    a, ma = make_train_step(cfg, opt)(s1, batch)
    b, mb = make_train_step(cfg, opt, donate=True)(s2, batch)
    assert [t.data_ptr() for t in tree_leaves(b.params)] == ptrs
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# fixed-mask value training against the reference
# ---------------------------------------------------------------------------

def test_sparse_value_train_step_matches_jax():
    """``sparse_ffn_lm``'s value fine-tuning (the smoke llama's unit-0 FFN
    down projection pruned to 0.2 in ``ehyb``, 64 tokens, AdamW): three
    steps of both packages from the same values, losses within 1e-5."""
    jcfg, jp, tcfg, tp = setup("llama3_2_1b")
    w_down = np.asarray(jax.tree.map(lambda a: a[0], jp["units"])
                        ["b0"]["ffn"]["w_down"])
    x = np.random.default_rng(1).standard_normal(
        (64, jcfg.d_ff)).astype(np.float32)
    y_goal = x @ w_down
    opt = dict(lr=2e-2, warmup_steps=0, weight_decay=0.0, clip_norm=1e9)

    jlin = japi.pruned_linear(w_down.T, density=0.2, format="ehyb")
    jxt = jnp.asarray(x.T[: jlin.op.n])
    jgoal = jnp.asarray(y_goal.T)

    def jloss(op):
        d = (op @ jxt)[: jcfg.d_model] - jgoal
        return jnp.vdot(d, d).real / d.size

    jv = jnp.asarray(jlin.op.values, jnp.float32)
    jopt = jinit_opt_state({"values": jv})
    jstep = jmake_value_step(jlin.op.plan, jloss, JOptimizerConfig(**opt))

    lin = pruned_linear(w_down.T, density=0.2, format="ehyb", device="cpu")
    xt = torch.as_tensor(x.T[: lin.op.n])
    goal = torch.as_tensor(y_goal.T)

    def loss_fn(op):
        d = (op @ xt)[: tcfg.d_model] - goal
        return (d * d).sum() / d.numel()

    v = lin.values.detach().clone()
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    topt = init_opt_state({"values": v})
    step = make_sparse_value_train_step(lin.op.plan, loss_fn,
                                        OptimizerConfig(**opt))
    losses = []
    for _ in range(3):
        jv, jopt, jm = jstep(jv, jopt)
        v, topt, tm = step(v, topt)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(
            jm["loss"])
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]
    assert rel(v.numpy(), np.asarray(jv)) <= 1e-5


@pytest.mark.parametrize("name", ["train_lm", "sparse_ffn_lm"])
def test_examples_run_on_the_cpu(name):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if name == "train_lm":
        first, resumed = mod.main(["--steps", "4", "--device", "cpu"])
        assert [h["step"] for h in first] == [0, 1, 2, 3]
        assert [h["step"] for h in resumed] == [4, 5]   # resumed at 4
    else:
        losses = mod.main(["--device", "cpu"])
        assert len(losses) == 20 and losses[-1] < losses[0]


def test_train_cli_never_resumes_another_run_by_default(tmp_path,
                                                      monkeypatch):
    """Without ``--ckpt-dir`` each run writes to a new directory under
    TMPDIR and starts at step 0; with it, a second run resumes."""
    import tempfile

    from repro_torch.launch import train as cli

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = ["--arch", "llama3_2_1b", "--smoke", "--steps", "2",
            "--global-batch", "2", "--seq-len", "16", "--device", "cpu"]
    for _ in range(2):
        assert [h["step"] for h in cli.main(args)] == [0, 1]
    made = sorted(tmp_path.glob("repro_torch_ckpt_*"))
    assert len(made) == 2 and all((d / "manifest.json").exists()
                                  for d in made)
    given = ["--ckpt-dir", str(tmp_path / "run")]
    assert [h["step"] for h in cli.main(args + given)] == [0, 1]
    assert [h["step"] for h in cli.main(args + given)] == [2, 3]

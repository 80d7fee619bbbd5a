"""The transform-safe operator: double backward, ``torch.func`` and
gradients through a bind on a mesh — against float64 formulas and JAX.

Mirrors what the JAX package's ``custom_vjp`` apply makes possible
(``tests/test_api.py``: ``test_vmap_over_rhs``,
``test_grad_through_bound_values_matches_dense[*-True]``,
``test_multi_device_sharded_grads``) on ``repro_torch`` (CPU):

* double backward, ``∇_v uᵀ ∇ₓ(wᵀ A(v) x) = w[rows]·u[cols]``, and a
  values HVP of ``½‖A(v) x‖²`` (``torch.autograd.functional.hvp``) for
  ``csr``, ``ehyb`` and ``ehyb_packed`` on a stencil and a power-law
  matrix, against the formula and ``jax.grad(jax.grad(…))``;
* ``torch.func.grad`` and ``jacrev`` against autograd and the dense
  matrix;
* ``torch.func.vmap`` over right-hand sides, over value sets and of a
  grad, against ``jax.vmap`` of the JAX package; a batch of right-hand
  sides is one batched apply, and a plain apply calls no autograd
  function;
* on gloo groups of 1, 2 and 4 ranks (``tests/torch_dist_worker.py``
  ``autodiff``): the value gradient through ``p.bind(v)`` on a sharded plan
  against the formula and the reference's one-device-mesh gradient, the
  permuted-space gradients, the double backward, a tensor bind's tables
  against the host bind's bit for bit with no host work, and
  ``update_values`` of a tensor.

On this jax the reference's ``ehyb_packed`` apply fails (``pl.load``), so
its JAX oracle is the reference's ``ehyb``.  Tolerances are the
reference's: 1e-5 of the largest entry for fp32 gradients, 5e-5 for vmap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import matrices as jmat
from repro_torch.api import ExecutionConfig, PlanCache, plan
from repro_torch.core.matrices import poisson3d, powerlaw
from test_torch_dist import run_ranks

FORMATS = ["csr", "ehyb", "ehyb_packed"]
MATS = {"stencil": (lambda: poisson3d(6), lambda: jmat.poisson3d(6)),
        "powerlaw": (lambda: powerlaw(192, 6),
                     lambda: jmat.powerlaw(192, 6))}
GRAD_TOL = 1e-5
VMAP_TOL = 5e-5


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def coo(m):
    return np.repeat(np.arange(m.n), m.row_lengths()), m.indices


def vecs(m, n_vec, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(m.n).astype(np.float32)
            for _ in range(n_vec)]


def tplan(m, fmt):
    return plan(m, execution=ExecutionConfig(format=fmt,
                                             partition_method="bfs"),
                device="cpu", cache=PlanCache())


def jplan(m, fmt):
    """The JAX package's plan of ``fmt`` (``ehyb`` for ``ehyb_packed``)."""
    return japi.plan(m, execution=japi.ExecutionConfig(
        format="ehyb" if fmt == "ehyb_packed" else fmt,
        partition_method="bfs"))


def tvals(m, requires_grad=False):
    return torch.tensor(m.data, dtype=torch.float32,
                        requires_grad=requires_grad)


# ---------------------------------------------------------------------------
# second order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", sorted(MATS))
def test_double_backward_matches_formula_and_jax(kind, fmt):
    """``∇_v uᵀ ∇ₓ(wᵀ A(v) x)`` through the backward's transpose bind:
    ``uᵀ Aᵀ w`` is linear in the values with gradient ``w[rows]·u[cols]``."""
    tm, jm = MATS[kind][0](), MATS[kind][1]()
    x, w, u = vecs(tm, 3)
    rows, cols = coo(tm)
    want = w.astype(np.float64)[rows] * u.astype(np.float64)[cols]
    p = tplan(tm, fmt)
    vals = tvals(tm, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    gx, = torch.autograd.grad((p.bind(vals) @ xt) @ torch.as_tensor(w), xt,
                              create_graph=True)
    assert gx.requires_grad
    gv, = torch.autograd.grad(gx @ torch.as_tensor(u), vals)
    assert rel(gv, want) <= GRAD_TOL
    jp = jplan(jm, fmt)
    jx, jw, ju = (jnp.asarray(a) for a in (x, w, u))
    jgv = jax.grad(lambda vv: jnp.vdot(jax.grad(
        lambda xx: jnp.vdot(jp.bind(vv) @ xx, jw))(jx), ju))(
            jnp.asarray(jm.data, jnp.float32))
    assert rel(gv, jgv) <= GRAD_TOL


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", sorted(MATS))
def test_values_hvp_matches_formula_and_jax(kind, fmt):
    """The values HVP of ``f(v) = ½‖A(v) x‖²``: ``Jᵀ J t`` with
    ``J t = A(t) x``, so ``(A(t) x)[rows]·x[cols]``."""
    tm, jm = MATS[kind][0](), MATS[kind][1]()
    x, = vecs(tm, 1, seed=1)
    t = np.random.default_rng(2).standard_normal(tm.nnz).astype(np.float32)
    rows, cols = coo(tm)
    xd = x.astype(np.float64)
    atx = np.bincount(rows, t * xd[cols], minlength=tm.n)
    want = atx[rows] * xd[cols]
    p = tplan(tm, fmt)
    xt = torch.as_tensor(x)
    _, hv = torch.autograd.functional.hvp(
        lambda v: 0.5 * (p.bind(v) @ xt).square().sum(), tvals(tm),
        torch.as_tensor(t))
    assert rel(hv, want) <= GRAD_TOL
    jp = jplan(jm, fmt)
    jx, jt = jnp.asarray(x), jnp.asarray(t)

    def f(vv):
        return 0.5 * jnp.sum(jnp.square(jp.bind(vv) @ jx))
    jhv = jax.grad(lambda vv: jnp.vdot(jax.grad(f)(vv), jt))(
        jnp.asarray(jm.data, jnp.float32))
    assert rel(hv, jhv) <= GRAD_TOL


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
def test_permuted_space_double_backward(fmt):
    """The same second-order gradient with x in the permuted space."""
    m = powerlaw(192, 6)
    x, w, u = vecs(m, 3, seed=3)
    rows, cols = coo(m)
    p = tplan(m, fmt)
    vals = tvals(m, requires_grad=True)
    op = p.bind(vals)
    x_new = op.to_space(x).requires_grad_(True)
    y_new = op.apply(x_new, space="permuted")
    gx, = torch.autograd.grad((y_new * op.to_space(w)).sum(), x_new,
                              create_graph=True)
    gv, = torch.autograd.grad((gx * op.to_space(u)).sum(), vals)
    want = w.astype(np.float64)[rows] * u.astype(np.float64)[cols]
    assert rel(gv, want) <= GRAD_TOL


# ---------------------------------------------------------------------------
# torch.func
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_func_grad_and_jacrev_match_autograd(fmt):
    m = poisson3d(6)
    x, w = vecs(m, 2, seed=4)
    p = tplan(m, fmt)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    vals = tvals(m, requires_grad=True)
    xg = xt.clone().requires_grad_(True)
    ((p.bind(vals) @ xg) @ wt).backward()
    gv = torch.func.grad(lambda v: (p.bind(v) @ xt) @ wt)(tvals(m))
    gx = torch.func.grad(lambda xx: (p.bind(tvals(m)) @ xx) @ wt)(xt)
    assert rel(gv, vals.grad) <= GRAD_TOL
    assert rel(gx, xg.grad) <= GRAD_TOL
    op = p.bind(m)
    jx = torch.func.jacrev(lambda xx: op @ xx)(xt)
    assert jx.shape == (m.n, m.n) and rel(jx, m.to_dense()) <= GRAD_TOL
    jv = torch.func.jacrev(lambda v: p.bind(v) @ xt)(tvals(m))
    rows, cols = coo(m)
    want = np.zeros((m.n, m.nnz))
    want[rows, np.arange(m.nnz)] = x.astype(np.float64)[cols]
    assert rel(jv, want) <= GRAD_TOL
    # and against autograd row by row: the jacobian's row i is ∇(A x)_i
    i = int(np.abs(x).argmax())
    gi, = torch.autograd.grad((p.bind(vals) @ xt)[i], vals)
    assert rel(jv[i], gi) <= GRAD_TOL


@pytest.mark.parametrize("fmt", FORMATS)
def test_vmap_over_rhs(fmt):
    """Mirrors the reference's ``test_vmap_over_rhs``: three right-hand
    sides of poisson3d(6), against the dense product and ``jax.vmap``."""
    tm, jm = poisson3d(6), jmat.poisson3d(6)
    X = np.random.default_rng(5).standard_normal((3, tm.n)).astype(
        np.float32)
    op = tplan(tm, fmt).bind(tm)
    Y = torch.func.vmap(lambda xx: op @ xx)(torch.as_tensor(X))
    assert Y.shape == (3, tm.n)
    assert rel(Y, X.astype(np.float64) @ tm.to_dense().T) <= VMAP_TOL
    jop = jplan(jm, fmt).bind(jm)
    jY = jax.vmap(lambda xx: jop @ xx)(jnp.asarray(X))
    assert rel(Y, jY) <= VMAP_TOL
    # a batch of (n, K) blocks, in the permuted space
    if fmt != "csr":
        XK = torch.as_tensor(np.random.default_rng(6).standard_normal(
            (2, tm.n, 3)).astype(np.float32))
        Xn = torch.stack([op.to_space(b) for b in XK])
        Yn = torch.func.vmap(lambda xx: op.apply(xx, space="permuted"))(Xn)
        got = torch.stack([op.from_space(b) for b in Yn])
        want = np.einsum("ij,bjk->bik", tm.to_dense(),
                         XK.double().numpy())
        assert rel(got, want) <= VMAP_TOL


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", sorted(MATS))
def test_vmap_over_value_sets(kind, fmt):
    tm, jm = MATS[kind][0](), MATS[kind][1]()
    x, = vecs(tm, 1, seed=7)
    V = np.stack([tm.data * s for s in (1.0, -0.5, 2.0)]).astype(
        np.float32)
    p = tplan(tm, fmt)
    xt = torch.as_tensor(x)
    Y = torch.func.vmap(lambda v: p.bind(v) @ xt)(torch.as_tensor(V))
    rows, cols = coo(tm)
    want = np.stack([np.bincount(rows, v.astype(np.float64)
                                 * x.astype(np.float64)[cols],
                                 minlength=tm.n) for v in V])
    assert rel(Y, want) <= VMAP_TOL
    jp = jplan(jm, fmt)
    jY = jax.vmap(lambda vv: jp.bind(vv) @ jnp.asarray(x))(jnp.asarray(V))
    assert rel(Y, jY) <= VMAP_TOL


@pytest.mark.parametrize("fmt", FORMATS)
def test_vmap_of_grad(fmt):
    """``vmap(grad)`` over value sets (the value gradient of each) and
    over right-hand sides (x̄ = Aᵀ w, batched through the backward's
    transpose apply), against ``jax.vmap(jax.grad)``."""
    tm, jm = powerlaw(192, 6), jmat.powerlaw(192, 6)
    x, w = vecs(tm, 2, seed=8)
    V = np.stack([tm.data * s for s in (1.0, 3.0)]).astype(np.float32)
    W = np.random.default_rng(9).standard_normal((4, tm.n)).astype(
        np.float32)
    p = tplan(tm, fmt)
    xt = torch.as_tensor(x)
    G = torch.func.vmap(torch.func.grad(
        lambda v, ww: (p.bind(v) @ xt) @ ww), in_dims=(0, None))(
            torch.as_tensor(V), torch.as_tensor(w))
    op = p.bind(tm)
    GX = torch.func.vmap(torch.func.grad(
        lambda xx, ww: (op @ xx) @ ww), in_dims=(None, 0))(
            xt, torch.as_tensor(W))
    jp = jplan(jm, fmt)
    jx = jnp.asarray(x)
    jG = jax.vmap(jax.grad(lambda vv: jnp.vdot(jp.bind(vv) @ jx,
                                               jnp.asarray(w))))(
        jnp.asarray(V))
    jop = jp.bind(jm)
    jGX = jax.vmap(lambda ww: jax.grad(
        lambda xx: jnp.vdot(jop @ xx, ww))(jx))(jnp.asarray(W))
    assert rel(G, jG) <= VMAP_TOL and rel(GX, jGX) <= VMAP_TOL
    rows, cols = coo(tm)
    gv = w.astype(np.float64)[rows] * x.astype(np.float64)[cols]
    assert rel(G, np.stack([gv, gv])) <= GRAD_TOL
    assert rel(GX, W.astype(np.float64) @ tm.to_dense()) <= GRAD_TOL


def _count_applies(p):
    """Wrap ``p``'s original-space guard so that each call records the
    shape of x."""
    calls = []
    guard = p._raw_apply()

    def counted(obj, x):
        calls.append(tuple(x.shape))
        return guard(obj, x)
    p._raw_apply = lambda: counted
    return calls


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
def test_vmapped_rhs_is_one_batched_apply(fmt):
    """``vmap`` over 16 right-hand sides is one ``(n, 16)`` apply (on the
    card the SpMM kernel, once), not 16 applies of one."""
    m = poisson3d(6)
    p = tplan(m, fmt)
    op = p.bind(m)
    calls = _count_applies(p)
    X = torch.randn(16, m.n)
    torch.func.vmap(lambda xx: op @ xx)(X)
    assert calls == [(m.n, 16)]
    # a batched cotangent: x̄ of each row through one transpose apply (the
    # pattern is symmetric, so the transpose plan is this plan)
    calls.clear()
    torch.func.vmap(torch.func.grad(lambda xx, ww: (op @ xx) @ ww),
                    in_dims=(None, 0))(X[0], X)
    assert calls == [(m.n,), (m.n, 16)]


def test_plain_apply_calls_no_autograd_function(monkeypatch):
    """With nothing requiring grad and no ``torch.func`` transform, the
    apply, the permuted apply, a solve and the pruned layer's eval forward
    keep their route: no autograd function is called."""
    from repro_torch.api import operator as opmod
    from repro_torch.api import pruned_linear

    m = poisson3d(6)
    p = tplan(m, "ehyb_packed")
    op = p.bind(tvals(m, requires_grad=True))
    layer = pruned_linear(np.random.default_rng(0).standard_normal(
        (24, 48)), 0.25, format="ehyb_packed", partition_method="bfs",
        device="cpu")

    def refuse(*a, **k):
        raise AssertionError("an autograd function was called")
    monkeypatch.setattr(opmod._DiffApply, "apply", refuse)
    x = torch.randn(m.n)
    assert (p.bind(m) @ x).grad_fn is None
    with torch.no_grad():
        op @ x
        op.apply(op.to_space(x), space="permuted")
        layer(torch.randn(3, 48))
    assert op.solve(torch.randn(m.n), tol=1e-6).status == "converged"


def test_lazy_bind_under_vmap_binds_each_set():
    """Under ``vmap`` over value sets the bind waits for the apply, which
    binds each set in turn, never the batch."""
    m = powerlaw(192, 6)
    p = tplan(m, "ehyb_packed")
    seen = []
    container = p._container

    def counted(values, dtype):
        seen.append(tuple(values.shape))
        return container(values, dtype)
    p._container = counted
    V = torch.stack([tvals(m) * s for s in (1.0, 2.0, 4.0)])
    Y = torch.func.vmap(lambda v: p.bind(v) @ torch.ones(m.n))(V)
    assert seen == [(m.nnz,)] * 3
    assert torch.allclose(Y[2], 4.0 * Y[0]) and torch.allclose(Y[1],
                                                              2.0 * Y[0])


# ---------------------------------------------------------------------------
# sharded: gloo groups of 1, 2 and 4 ranks
# ---------------------------------------------------------------------------

WORLDS = [1, 2, 4]
SHARDED_MATS = {"poisson": (lambda: jmat.poisson3d(8)),
                "powerlaw": (lambda: jmat.powerlaw(512, 6))}


@pytest.fixture(scope="module")
def ad_ranks(tmp_path_factory):
    return {n: run_ranks("autodiff", n, tmp_path_factory.mktemp(f"ad{n}"))
            for n in WORLDS}


def _combos():
    return [(n, f) for n in sorted(SHARDED_MATS)
            for f in ("ehyb", "ehyb_packed")]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_value_grad_matches_dense_and_reference(ad_ranks, world):
    """The value gradient through ``p.bind(v)`` on a sharded plan (the
    reference's ``test_grad_through_bound_values_matches_dense[*-True]``
    and ``test_multi_device_sharded_grads``), the same on every rank,
    against the formula and the reference's one-device-mesh gradient on
    the same seeded vectors; x's gradient against Aᵀ w."""
    from repro.compat import make_mesh

    res = ad_ranks[world]
    assert res["world"] == world and not res["jax_loaded"]
    for name, fmt in _combos():
        key = f"{name}/{fmt}/"
        assert res[key + "gv"] <= GRAD_TOL, key
        assert res[key + "gx"] <= GRAD_TOL, key
        assert res[key + "grad_same_on_ranks"], key
        m = SHARDED_MATS[name]()
        x, w = (np.random.default_rng(s).standard_normal(m.n).astype(
            np.float32) for s in (1, 2))
        jp = japi.plan(m, mesh=make_mesh((1,), ("data",)),
                       execution=japi.ExecutionConfig(
                           format=fmt, partition_method="bfs"))
        jgv = jax.grad(lambda vv: jnp.vdot(jp.bind(vv) @ jnp.asarray(x),
                                           jnp.asarray(w)))(
            jnp.asarray(m.data, jnp.float32))
        assert rel(res[key + "gv_values"], jgv) <= GRAD_TOL, key


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_permuted_space_grads(ad_ranks, world):
    """The permuted-space apply on the rank's shard: ḡ and x gathered to
    the original space, x̄ cut back to the shard, the padding slots 0."""
    res = ad_ranks[world]
    for name, fmt in _combos():
        key = f"{name}/{fmt}/"
        assert res[key + "perm_gx"] <= GRAD_TOL, key
        assert res[key + "perm_gv"] <= GRAD_TOL, key
        assert res[key + "perm_pad_zero"], key


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_double_backward(ad_ranks, world):
    res = ad_ranks[world]
    for name, fmt in _combos():
        assert res[f"{name}/{fmt}/double"] <= GRAD_TOL, (name, fmt)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_tensor_bind_on_device(ad_ranks, world):
    """A tensor bind's three value tables equal the host bind's bit for
    bit in fp32 and bf16 on every rank, and the bind, its apply and its
    backward call neither ``EHYB.refill`` nor ``matrix_key``; a bare
    ``EHYBDevice`` shard refuses a tensor."""
    res = ad_ranks[world]
    for name, fmt in _combos():
        assert res[f"{name}/{fmt}/tables_bit_identical"], (name, fmt)
        assert res[f"{name}/{fmt}/values_of"] <= 1e-7, (name, fmt)
    assert res["bare/tensor_refused"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_update_values_tensor(ad_ranks, world):
    res = ad_ranks[world]
    for name, fmt in _combos():
        key = f"{name}/{fmt}/"
        assert res[key + "update_op"] <= 1e-5, key
        assert res[key + "update_engine"] <= 1e-5, key
        assert res[key + "update_engine_shared"], key

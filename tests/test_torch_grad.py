"""Gradients through the port's apply, against float64 oracles and JAX.

Mirrors ``tests/test_api.py``'s differentiation cases (grad w.r.t. x,
w.r.t. the bound values, no double counting, the fp64 cotangent) and
``tests/test_spmm.py``'s batched VJPs on ``repro_torch`` (CPU): the
autograd function of ``api.operator`` (``v̄ₖ = Σ_r ḡ[rowₖ, r]·x[colₖ, r]``,
x̄ = Aᵀ ḡ through the transpose plan) for both formats at K = 1 and K = 4,
within 1e-5 (relative to the largest entry) of float64 dense oracles and
of ``jax.grad`` of the JAX package's ``ehyb`` (XLA) apply on the same
seeded inputs; the pruned layer's gradients against the JAX layer's; the
permuted-space apply's; the transpose operator; and that a solve or an
apply with nothing requiring grad builds no graph.  The reference's own
no-double-counting and fp64-cotangent tests fail on the installed jax, so
those two cases hold the port against numpy float64 alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import matrices as jmat
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import ExecutionConfig, PlanCache, plan
from repro_torch.core.matrices import SparseCSR, poisson3d, powerlaw

FORMATS = ["ehyb", "ehyb_packed"]
MATS = {"stencil": (lambda: poisson3d(6), lambda: jmat.poisson3d(6)),
        "powerlaw": (lambda: powerlaw(192, 6), lambda: jmat.powerlaw(192, 6))}


def pinned(fmt):
    return ExecutionConfig(format=fmt, partition_method="bfs")


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def coo(m):
    return np.repeat(np.arange(m.n), m.row_lengths()), m.indices


def inputs(m, k, seed=0):
    """x and the cotangent v, (n,) for k = 1 else (n, k), float32."""
    rng = np.random.default_rng(seed)
    shape = (m.n,) if k == 1 else (m.n, k)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def value_grad_oracle(m, x, v):
    rows, cols = coo(m)
    x2 = np.asarray(x, np.float64).reshape(m.n, -1)
    v2 = np.asarray(v, np.float64).reshape(m.n, -1)
    return np.einsum("kr,kr->k", v2[rows], x2[cols])


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", sorted(MATS))
def test_grads_match_dense_and_jax(kind, fmt, k):
    tm, jm = MATS[kind][0](), MATS[kind][1]()
    x, v = inputs(tm, k)
    d = tm.to_dense()
    gx_ref = d.T @ v.astype(np.float64)
    gv_ref = value_grad_oracle(tm, x, v)
    # the port: values bound from a tensor, x requiring grad
    p = plan(tm, execution=pinned(fmt), device="cpu", cache=PlanCache())
    vals = torch.tensor(tm.data, dtype=torch.float32, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y = p.bind(vals) @ xt
    (y * torch.as_tensor(v)).sum().backward()
    assert xt.grad.dtype == torch.float32 and vals.grad.dtype == torch.float32
    assert rel(xt.grad, gx_ref) <= 1e-5
    assert rel(vals.grad, gv_ref) <= 1e-5
    # jax.grad of the JAX package's ehyb (XLA) apply on the same inputs
    jp = japi.plan(jm, execution=japi.ExecutionConfig(
        format="ehyb", partition_method="bfs"))
    jop = jp.bind(jm)
    jx, jv = jnp.asarray(x), jnp.asarray(v)
    jgx = jax.grad(lambda xx: jnp.vdot(jop @ xx, jv))(jx)
    jgv = jax.grad(lambda vv: jnp.vdot(jp.bind(vv) @ jx, jv))(
        jnp.asarray(jm.data, jnp.float32))
    assert rel(xt.grad, jgx) <= 1e-5
    assert rel(vals.grad, jgv) <= 1e-5


@pytest.mark.parametrize("fmt", FORMATS)
def test_grad_x_of_a_host_bound_operator(fmt):
    """An operator bound from host values differentiates w.r.t. x alone."""
    m = powerlaw(192, 6)
    op = plan(m, execution=pinned(fmt), device="cpu").bind(m)
    x, v = inputs(m, 4, seed=3)
    xt = torch.tensor(x, requires_grad=True)
    (op @ xt * torch.as_tensor(v)).sum().backward()
    assert rel(xt.grad, m.to_dense().T @ v.astype(np.float64)) <= 1e-5


@pytest.mark.parametrize("fmt", FORMATS)
def test_value_grads_never_double_count(fmt):
    """Each ER value is stored in three tables (the global ER table, the
    grouped tiles, the compact stream); its cotangent counts once."""
    m = powerlaw(192, 6)
    p = plan(m, execution=pinned(fmt), device="cpu", cache=PlanCache())
    op = p.bind(m)
    assert op.obj.has_er and op.obj.er_s_vals.numel() > 0
    x, v = inputs(m, 1, seed=1)
    vals = torch.tensor(m.data, dtype=torch.float32, requires_grad=True)
    (p.bind(vals) @ torch.as_tensor(x) * torch.as_tensor(v)).sum().backward()
    gv_ref = value_grad_oracle(m, x, v)
    assert rel(vals.grad, gv_ref) <= 1e-5
    # and a gradient through the values is the derivative of the apply:
    # y is linear in the values, so <v, A(vals) x> == <grad, vals>
    y = (p.bind(vals.detach()) @ torch.as_tensor(x)).double()
    assert abs(float((y * torch.as_tensor(v).double()).sum())
               - float((vals.grad.double() * vals.detach().double()).sum())
               ) <= 1e-4 * float(np.abs(gv_ref * m.data).sum())


def test_fp64_cotangent_not_downcast():
    """Values stored at fp32, x and the cotangent at fp64: x̄ = Aᵀ ḡ runs at
    fp64 on the transpose plan (bound at the accumulation dtype), so it
    agrees with the float64 oracle of the fp32-rounded values to fp64
    resolution."""
    m = poisson3d(6)
    m32 = SparseCSR(m.n, m.indptr, m.indices,
                    m.data.astype(np.float32).astype(np.float64))
    op = plan(m, execution=pinned("ehyb_packed"), device="cpu").bind(m)
    assert op.dtype == torch.float32
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal(m.n), dtype=torch.float64,
                     requires_grad=True)
    v = rng.standard_normal(m.n)
    y = op @ x
    assert y.dtype == torch.float64
    (y * torch.as_tensor(v)).sum().backward()
    assert x.grad.dtype == torch.float64
    assert rel(x.grad, m32.to_dense().T @ v) < 1e-10


@pytest.mark.parametrize("fmt", FORMATS)
def test_permuted_space_grads(fmt):
    m = powerlaw(192, 6)
    p = plan(m, execution=pinned(fmt), device="cpu", cache=PlanCache())
    vals = torch.tensor(m.data, dtype=torch.float32, requires_grad=True)
    op = p.bind(vals)
    x, v = inputs(m, 4, seed=2)
    x_new = op.to_space(x).requires_grad_(True)
    v_new = op.to_space(v)
    y_new = op.apply(x_new, space="permuted")
    (y_new * v_new).sum().backward()
    gx = op.from_space(x_new.grad)
    assert rel(gx, m.to_dense().T @ v.astype(np.float64)) <= 1e-5
    pad = torch.ones(op.n_pad, dtype=torch.bool)
    pad[op.obj.inv_perm[: m.n]] = False
    assert not bool(x_new.grad[pad].any())
    assert rel(vals.grad, value_grad_oracle(m, x, v)) <= 1e-5


@pytest.mark.parametrize("fmt", FORMATS)
def test_bf16_operator_grads(fmt):
    """bf16 tables: the backward accumulates in fp32 and binds the
    transpose at fp32; the gradients agree with the oracle of the
    bf16-rounded values within bf16 resolution."""
    m = poisson3d(6)
    p = plan(m, execution=pinned(fmt), device="cpu", cache=PlanCache())
    vals = torch.tensor(m.data, dtype=torch.float32, requires_grad=True)
    op = p.bind(vals, dtype=torch.bfloat16)
    x, v = inputs(m, 4, seed=4)
    xt = torch.tensor(x, requires_grad=True)
    y = op @ xt
    assert y.dtype == torch.float32
    (y * torch.as_tensor(v)).sum().backward()
    m16 = SparseCSR(m.n, m.indptr, m.indices, p.values_of(op.obj).double()
                    .numpy())
    assert rel(xt.grad, m16.to_dense().T @ v.astype(np.float64)) <= 1e-5
    x16 = torch.as_tensor(x).bfloat16().double().numpy()
    assert rel(vals.grad, value_grad_oracle(m, x, v)) <= 1e-5
    assert rel(vals.grad, value_grad_oracle(m, x16, v)) <= 1e-2


def test_transpose_operator_and_plan():
    m = powerlaw(128, 5)
    p = plan(m, execution=pinned("ehyb_packed"), device="cpu",
             cache=PlanCache())
    op = p.bind(m)
    x = np.random.default_rng(0).standard_normal(m.n)
    np.testing.assert_allclose((op.T @ x).double().numpy(),
                               m.to_dense().T @ x, rtol=1e-4, atol=1e-4)
    assert p.transpose is not p and p.transpose is p.transpose
    assert p.transpose.transpose is p          # Aᵀᵀ is A's plan: a hit
    t = p.transpose_order()
    assert t is p.transpose_order()
    rows, cols = p.coo()
    assert np.array_equal(np.lexsort((rows, cols)), t)
    # a structurally symmetric pattern is its own transpose plan
    s = plan(poisson3d(6), execution=pinned("ehyb_packed"), device="cpu")
    assert s.transpose is s


def test_no_graph_without_grad():
    """Nothing requires grad, or grad mode is off: the guard alone runs;
    a solve never builds a graph, even on values that require grad."""
    m = poisson3d(6)
    p = plan(m, execution=pinned("ehyb_packed"), device="cpu",
             cache=PlanCache())
    x = torch.randn(m.n)
    assert (p.bind(m) @ x).grad_fn is None
    vals = torch.tensor(m.data, dtype=torch.float32, requires_grad=True)
    op = p.bind(vals)
    assert (op @ x).grad_fn is not None
    with torch.no_grad():
        assert (op @ x).grad_fn is None
        assert op.apply(op.to_space(x), space="permuted").grad_fn is None
    b = torch.randn(m.n, requires_grad=True)
    r = op.solve(b, tol=1e-6)
    assert r.status == "converged"
    assert r.x.grad_fn is None and not r.x.requires_grad


@pytest.mark.parametrize("fmt", FORMATS)
def test_pruned_layer_grads_match_jax(fmt):
    """The layer's ``values.grad`` and the input's gradient against the JAX
    layer's (``jax.grad`` through ``apply_with`` on a traced bind) and the
    float64 oracle, at 6 tokens."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((48, 96))
    x = rng.standard_normal((2, 3, 96)).astype(np.float32)
    t = rng.standard_normal((2, 3, 48)).astype(np.float32)
    layer = tapi.pruned_linear(w, 0.2, format=fmt, partition_method="bfs",
                               k=6, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    (layer(xt) * torch.as_tensor(t)).sum().backward()
    jl = japi.pruned_linear(w, 0.2, format="ehyb", partition_method="bfs")
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    jgx = jax.grad(lambda xx: jnp.vdot(jl(xx), jt))(jx)
    jvals = jnp.asarray(jl.csr.data, jnp.float32)
    jgv = jax.grad(lambda vv: jnp.vdot(
        jl.apply_with(jl.op.plan.bind(vv).obj, jx), jt))(jvals)
    assert layer.values.shape == jvals.shape
    assert rel(xt.grad, jgx) <= 1e-5
    assert rel(layer.values.grad, jgv) <= 1e-5
    # float64: W_pruned = the layer's CSR, y = x Wᵀ
    c = layer.csr
    rows, cols = coo(c)
    x2 = x.reshape(-1, 96).astype(np.float64)
    t2 = t.reshape(-1, 48).astype(np.float64)
    dense = c.to_dense()[:48, :96]
    assert rel(xt.grad.reshape(-1, 96), t2 @ dense) <= 1e-5
    assert rel(layer.values.grad,
               np.einsum("tk,tk->k", t2[:, rows], x2[:, cols])) <= 1e-5


def test_converted_layer_carries_gradients():
    """A JAX layer carried across (``convert.sparse_linear``) trains the
    same way."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((32, 64))
    x = rng.standard_normal((4, 64)).astype(np.float32)
    jl = japi.pruned_linear(w, 0.25, format="ehyb_packed",
                            partition_method="bfs")
    leaves = {f: np.asarray(getattr(jl.op.obj, f)) for f in (
        "packed_vals", "packed_cols", "col_starts", "col_rows", "er_vals",
        "er_cols", "er_row_idx", "er_p_vals", "er_p_cols", "er_p_rows",
        "perm", "inv_perm")}
    static = {f: getattr(jl.op.obj, f) for f in (
        "n", "n_pad", "n_parts", "vec_size", "has_er")}
    layer = convert.sparse_linear(
        "EHYBPackedDevice", leaves, static, csr=jl.csr, d_in=64, d_out=32,
        density=0.25, partition_method="bfs", device="cpu")
    layer(torch.as_tensor(x)).sum().backward()
    rows, cols = coo(layer.csr)
    keep = rows < 32
    want = np.zeros(layer.csr.nnz)
    want[keep] = x.astype(np.float64).sum(0)[cols[keep]]
    assert rel(layer.values.grad, want) <= 1e-5


# ---------------------------------------------------------------------------
# the layer's parameter decides its output
# ---------------------------------------------------------------------------

def _fresh_layer(layer, vals):
    """A layer bound afresh (its own plan cache) to the per-nnz ``vals`` on
    ``layer``'s mask, with ``layer``'s execution."""
    from repro_torch.core.sparse_linear import SparseLinear

    c = layer.csr
    m = SparseCSR(c.n, c.indptr, c.indices,
                  vals.detach().double().cpu().numpy())
    op = plan(m, execution=layer.op.plan.execution, device="cpu",
              cache=PlanCache()).bind(m, dtype=layer.op.dtype)
    return SparseLinear(d_in=layer.d_in, d_out=layer.d_out, op=op,
                        density=layer.density, csr=m)


def _layer(fmt, seed=8):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((40, 72))
    x = torch.as_tensor(rng.standard_normal((5, 72)).astype(np.float32))
    t = torch.as_tensor(rng.standard_normal((5, 40)).astype(np.float32))
    layer = tapi.pruned_linear(w, 0.2, format=fmt, partition_method="bfs",
                               k=5, device="cpu")
    return w, x, t, layer


@pytest.mark.parametrize("fmt", FORMATS)
def test_optimizer_step_changes_the_layer_output(fmt):
    """One ``torch.optim.SGD`` step on ``layer.parameters()``: the next
    forward is, bit for bit, that of a layer bound afresh to the stepped
    values, and differs from the forward before the step."""
    from repro_torch.core import counters

    _, x, t, layer = _layer(fmt)
    opt = torch.optim.SGD(layer.parameters(), lr=0.5)
    y0 = layer(x)
    ((y0 - t) ** 2).mean().backward()
    opt.step()
    before = counters.snapshot()
    with torch.no_grad():
        y1 = layer(x)
    after = counters.snapshot()
    assert all(after.get(c, 0) == before.get(c, 0) for c in (
        "partition", "build_ehyb", "pack_staircase", "group_er",
        "ehyb_refill"))
    with torch.no_grad():
        want = _fresh_layer(layer, layer.values)(x)
    assert torch.equal(y1, want)
    assert not torch.equal(y1, y0.detach())
    torch.testing.assert_close(layer.op.values, layer.values.detach(),
                               rtol=0, atol=0)
    # an unchanged parameter rebinds nothing
    op = layer.op
    with torch.no_grad():
        layer(x)
    assert layer.op is op


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_state_dict_changes_the_layer_output(fmt):
    """``load_state_dict`` of another layer on the same mask makes this
    layer compute that layer's output."""
    w, x, _, a = _layer(fmt)
    b = tapi.pruned_linear(-1.5 * w, 0.2, format=fmt,
                           partition_method="bfs", k=5, device="cpu")
    with torch.no_grad():
        ya, yb = a(x), b(x)
    assert not torch.equal(ya, yb)
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        assert torch.equal(b(x), ya)


def test_in_place_edit_and_new_parameter_are_seen():
    _, x, _, layer = _layer("ehyb_packed")
    with torch.no_grad():
        y = layer(x)
        layer.values.mul_(2.0)
        torch.testing.assert_close(layer(x), 2.0 * y, rtol=1e-6, atol=1e-6)
    layer.values = torch.nn.Parameter(-layer.values.detach())
    with torch.no_grad():
        torch.testing.assert_close(layer(x), -2.0 * y, rtol=1e-6,
                                   atol=1e-6)
    # gradients reach the new parameter
    layer(x).sum().backward()
    assert layer.values.grad is not None


@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
def test_output_dtype_is_the_same_with_and_without_grad(table):
    """One output-dtype rule on both paths: the wider of x's dtype and the
    tables'."""
    m = poisson3d(6)
    p = plan(m, execution=pinned("ehyb_packed"), device="cpu",
             cache=PlanCache())
    vals = torch.tensor(m.data, dtype=torch.float32, requires_grad=True)
    op = p.bind(vals, dtype=table)
    for x_dtype in (torch.float32, torch.bfloat16, torch.float64):
        x = torch.randn(m.n, dtype=x_dtype)
        y_grad = op @ x
        with torch.no_grad():
            y_plain = op @ x
        assert y_grad.requires_grad and not y_plain.requires_grad
        assert y_grad.dtype == y_plain.dtype == torch.promote_types(
            x_dtype, table)
        assert torch.equal(y_grad.detach(), y_plain)
    layer = tapi.pruned_linear(np.random.default_rng(0).standard_normal(
        (24, 48)), 0.25, format="ehyb_packed", partition_method="bfs",
        dtype=table, device="cpu")
    xs = torch.randn(3, 48)
    y_train = layer(xs)
    with torch.no_grad():
        y_eval = layer(xs)
    assert y_train.dtype == y_eval.dtype == torch.float32

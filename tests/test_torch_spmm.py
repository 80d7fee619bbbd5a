"""The port's batched (n, K) apply and pruned sparse layer against the JAX
package, on the CPU.

Mirrors ``tests/test_spmm.py``: the same matrices (``poisson3d(6)``,
``powerlaw(192, 6)``), rhs widths and tolerances — max|Δ| / max|Y_ref| ≤ 5e-5
in fp32 and 5e-2 in bf16 against the float64 dense oracle.  The JAX apply is
its ``ehyb`` (XLA) path; bf16 is held against the dense oracle only, since
the reference's own bf16 SpMM cases fail on the installed jax.  The uniform
SpMM Pallas kernels run in interpret mode; the packed ones cannot run on the
installed jax (``pl.load`` is gone), so the packed plain versions are held
against ``repro.core.spmv.ehyb_spmv_permuted`` and against the uniform
plain versions on the unpacked tiles.  The fused SpMM wrappers read the ER
part from the compact stream (``er_s_*``), as their plain versions do.  Inputs come from numpy with a seed.
"""

import dataclasses
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ehyb as jehyb
from repro.core import matrices as jmat
from repro.core.spmv import EHYBDevice as JEHYBDevice
from repro.core.spmv import EHYBPackedDevice as JEHYBPackedDevice
from repro.core.spmv import ehyb_spmv_permuted as jax_ehyb_spmv_permuted
from repro.core.sparse_linear import prune_to_csr as jax_prune_to_csr
from repro.kernels.ehyb_spmm import (ehyb_ell_spmm_pallas,
                                     ehyb_fused_spmm_pallas)
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import plan as tplan
from repro_torch.core.matrices import from_coo
from repro_torch.core.partition import choose_vec_size_cuda
from repro_torch.core.sparse_linear import (EHYBLinear, SparseLinear,
                                            prune_to_csr)
from repro_torch.kernels import ehyb_spmm as KM
from repro_torch.kernels import ehyb_spmv as K
from repro_torch.kernels import ops, ref

TOL = {"f32": (jnp.float32, torch.float32, 5e-5),
       "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
STATIC = ("n", "n_pad", "n_parts", "vec_size", "has_er")


def _mats(kind):
    j = jmat.poisson3d(6) if kind == "stencil" else jmat.powerlaw(192, 6)
    return convert.csr_from_arrays(j.n, j.indptr, j.indices, j.data), j


def _err(y, y_ref):
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    return np.abs(y - y_ref).max() / (np.abs(y_ref).max() + 1e-30)


def _leaves(obj):
    """A JAX container as (kind, {field: numpy}, {static field: value})."""
    names = [f.name for f in dataclasses.fields(obj)
             if not isinstance(getattr(obj, f.name), (int, bool, tuple))]
    return (type(obj).__name__, {k: np.asarray(getattr(obj, k))
                                 for k in names},
            {k: getattr(obj, k) for k in STATIC})


def _port_container(obj, e):
    """The port's container on the JAX container's tables; ``e``, the host
    build they came from, lays out the port's own fields."""
    return convert.device_container(*_leaves(obj), device="cpu", host=e)


def _port_op(m, fmt, k=1, dtype=torch.float32):
    return tplan(m, execution=tapi.ExecutionConfig(
        format=fmt, partition_method="bfs", k=k), device="cpu").bind(
        m, dtype=dtype)


# ---------------------------------------------------------------------------
# conformance: op @ X against the JAX apply and the float64 dense oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["stencil", "powerlaw"])
@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("dt", sorted(TOL))
def test_spmm_conformance_matches_jax_and_dense(kind, k, dt):
    jdt, tdt, tol = TOL[dt]
    tm, jm = _mats(kind)
    x = np.random.default_rng(0).standard_normal((tm.n, k))
    want = jm.to_dense() @ x
    if dt == "f32":
        jop = japi.plan(jm, execution=japi.ExecutionConfig(
            format="ehyb", partition_method="bfs", k=k)).bind(jm)
        y_jax = np.asarray(jop @ jnp.asarray(x, jdt), np.float64)
        assert _err(y_jax, want) < tol
    for fmt in ("ehyb", "ehyb_packed"):
        op = _port_op(tm, fmt, k, tdt)
        y = op @ x
        assert y.shape == (tm.n, k) and y.dtype == tdt
        y = y.double().numpy()
        assert _err(y, want) < tol, (fmt, kind, k, dt)
        if dt == "f32":
            assert _err(y, y_jax) < tol, (fmt, kind, k)


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
def test_batched_apply_equals_column_applies(fmt):
    tm, _ = _mats("stencil")
    op = _port_op(tm, fmt, k=8)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((tm.n, 8)),
                        dtype=torch.float32)
    y = op @ x
    cols = torch.stack([op @ x[:, j] for j in range(8)], dim=1)
    torch.testing.assert_close(y, cols, rtol=1e-5, atol=1e-5)
    # the permuted space takes and returns (n_pad, K) batches too
    x_new = op.to_space(x)
    assert x_new.shape == (op.n_pad, 8)
    y_new = op.apply(x_new, space=tapi.Space.PERMUTED)
    torch.testing.assert_close(op.from_space(y_new), y, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# plain versions against the Pallas SpMM kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rhs_chunk", [None, 3])
@pytest.mark.parametrize("dt", sorted(TOL))
def test_plain_spmm_matches_pallas_interpret(dt, rhs_chunk):
    jdt, tdt, tol = TOL[dt]
    _, jm = _mats("powerlaw")
    e = jehyb.build_ehyb(jm, method="bfs")
    jd = JEHYBDevice.from_ehyb(e, jdt)
    td = _port_container(jd, e)
    x = np.random.default_rng(2).standard_normal((jd.n_pad, 5))
    xj = jnp.asarray(x, jdt)
    xt = torch.as_tensor(x).to(tdt)
    want = ehyb_fused_spmm_pallas(xj, jd.ell_vals, jd.ell_cols, jd.er_p_vals,
                                  jd.er_p_cols, jd.er_p_rows, interpret=True,
                                  rhs_chunk=rhs_chunk)
    n0 = KM.ehyb_fused_spmm.launches
    got = KM.ehyb_fused_spmm(xt, td.ell_vals, td.ell_cols, td.col_rows,
                             td.er_stream(), rhs_chunk=rhs_chunk)
    assert KM.ehyb_fused_spmm.launches == n0        # CPU: no kernel launched
    assert got.dtype == tdt and got.shape == (jd.n_pad, 5)
    assert _err(got.double(), np.asarray(want, np.float64)) <= tol
    xp = x.reshape(jd.n_parts, jd.vec_size, 5)
    want = ehyb_ell_spmm_pallas(jnp.asarray(xp, jdt), jd.ell_vals,
                                jd.ell_cols, interpret=True,
                                rhs_chunk=rhs_chunk)
    got = KM.ehyb_ell_spmm(torch.as_tensor(xp).to(tdt), td.ell_vals,
                           td.ell_cols, td.col_rows, rhs_chunk=rhs_chunk)
    assert got.dtype == tdt and got.shape == xp.shape
    assert _err(got.double(), np.asarray(want, np.float64)) <= tol


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("kind", ["stencil", "powerlaw"])
def test_packed_plain_spmm_matches_uniform_and_jax(kind, dt):
    jdt, tdt, tol = TOL[dt]
    _, jm = _mats(kind)
    e = jehyb.build_ehyb(jm, method="bfs")
    jp = _port_container(JEHYBPackedDevice.from_packed(
        jehyb.pack_staircase(e), jdt), e)
    ju = JEHYBDevice.from_ehyb(e, jdt)
    tu = _port_container(ju, e)
    x = np.random.default_rng(3).standard_normal((e.n_pad, 5))
    xt = torch.as_tensor(x).to(tdt)
    xp = xt.reshape(e.n_parts, e.vec_size, 5)
    # ELL-only: packed == uniform on the unpacked tiles (the same sums)
    got = KM.ehyb_ell_packed_spmm(xp, jp.packed_vals, jp.packed_cols,
                                  jp.col_starts, jp.col_rows, rhs_chunk=3)
    torch.testing.assert_close(got, ref.ehyb_ell_ref(xp, tu.ell_vals,
                                                     tu.ell_cols,
                                                     tu.col_rows),
                               rtol=0, atol=0)
    # fused: against the JAX permuted-space apply on the same build
    want = np.asarray(jax_ehyb_spmv_permuted(ju, jnp.asarray(x, jdt)),
                      np.float64)
    got = KM.ehyb_packed_fused_spmm(xt, jp.packed_vals, jp.packed_cols,
                                    jp.col_starts, jp.col_rows,
                                    jp.er_stream(), vec_size=jp.vec_size)
    assert got.dtype == tdt and got.shape == (e.n_pad, 5)
    assert _err(got.double(), want) <= tol
    torch.testing.assert_close(
        got, KM.ehyb_fused_spmm(xt, tu.ell_vals, tu.ell_cols, tu.col_rows,
                                tu.er_stream()), rtol=0, atol=0)


@pytest.mark.parametrize("k", [4, 32])
@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("kind", ["stencil", "powerlaw"])
def test_stream_plain_spmm_matches_pallas_and_jax(kind, dt, k):
    """The plain versions of #7 and #8 (``ref.ehyb_fused_stream_ref`` and
    ``ref.ehyb_packed_fused_stream_ref``, the ER part from the compact
    stream), which the SpMM wrappers run on the CPU, against
    ``ehyb_fused_spmm_pallas`` in interpret mode and the JAX
    permuted-space apply on the same tables."""
    jdt, tdt, tol = TOL[dt]
    _, jm = _mats(kind)
    e = jehyb.build_ehyb(jm, method="bfs")
    ju = JEHYBDevice.from_ehyb(e, jdt)
    tu = _port_container(ju, e)
    tp = _port_container(JEHYBPackedDevice.from_packed(
        jehyb.pack_staircase(e), jdt), e)
    x = np.random.default_rng(k).standard_normal((e.n_pad, k))
    xj, xt = jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)
    pallas = np.asarray(ehyb_fused_spmm_pallas(
        xj, ju.ell_vals, ju.ell_cols, ju.er_p_vals, ju.er_p_cols,
        ju.er_p_rows, interpret=True), np.float64)
    jax_apply = np.asarray(jax_ehyb_spmv_permuted(ju, xj), np.float64)
    n0 = (KM.ehyb_fused_spmm.launches, KM.ehyb_packed_fused_spmm.launches)
    got = {"uniform": KM.ehyb_fused_spmm(xt, tu.ell_vals, tu.ell_cols,
                                         tu.col_rows, tu.er_stream()),
           "packed": KM.ehyb_packed_fused_spmm(
               xt, tp.packed_vals, tp.packed_cols, tp.col_starts,
               tp.col_rows, tp.er_stream(), vec_size=tp.vec_size)}
    assert (KM.ehyb_fused_spmm.launches,
            KM.ehyb_packed_fused_spmm.launches) == n0   # CPU: plain only
    torch.testing.assert_close(got["uniform"], ref.ehyb_fused_stream_ref(
        xt, tu.ell_vals, tu.ell_cols, tu.col_rows, tu.er_stream()), rtol=0,
        atol=0)
    for layout, y in got.items():
        assert y.dtype == tdt and y.shape == (e.n_pad, k)
        assert _err(y.double(), pallas) <= tol, layout
        assert _err(y.double(), jax_apply) <= tol, layout


def test_rhs_chunk_is_validated():
    tm, _ = _mats("stencil")
    o = _port_op(tm, "ehyb").obj
    x = torch.zeros((o.n_pad, 4))
    for bad in (0, 33, 2.5):
        with pytest.raises(ValueError, match="rhs_chunk"):
            KM.ehyb_fused_spmm(x, o.ell_vals, o.ell_cols, o.col_rows,
                               o.er_stream(), rhs_chunk=bad)
    # Kc: the request, cut to K and to what the block's shared memory holds
    assert KM.rhs_chunk_for(40, 1504, 4, None, 232448) == 16
    assert KM.rhs_chunk_for(5, 1504, 4, None, 232448) == 5
    assert KM.rhs_chunk_for(40, 1504, 4, 32, 232448) == 19
    assert KM.rhs_chunk_for(16, 5984, 4, None, 232448) == 4
    assert KM.rhs_chunk_for(16, 5984, 2, None, 232448) == 6
    with pytest.raises(ValueError, match="shared memory"):
        KM.rhs_chunk_for(4, 40000, 4, None, 232448)


# ---------------------------------------------------------------------------
# the routing of kernels.ops
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    """Record which wrapper each routed apply reaches (they still compute,
    through their plain versions on the CPU)."""
    seen = []
    for mod, name in ((K, "ehyb_fused"), (K, "ehyb_packed_fused"),
                      (K, "ehyb_ell"), (K, "ehyb_ell_packed"),
                      (KM, "ehyb_fused_spmm"), (KM, "ehyb_packed_fused_spmm"),
                      (KM, "ehyb_ell_spmm"), (KM, "ehyb_ell_packed_spmm")):
        real = getattr(mod, name)

        def fake(*a, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, fake)
    return seen


ROUTES = {"ehyb": (ops.ehyb_spmv_fused_permuted, "ehyb_fused",
                   "ehyb_fused_spmm", "ehyb_ell_spmm", "ehyb_ell"),
          "ehyb_packed": (ops.ehyb_spmv_packed_permuted, "ehyb_packed_fused",
                          "ehyb_packed_fused_spmm", "ehyb_ell_packed_spmm",
                          "ehyb_ell_packed")}


@pytest.mark.parametrize("fmt", sorted(ROUTES))
def test_routing_by_rhs_width_and_er(fmt, calls):
    apply, spmv, fused, ell, ell1 = ROUTES[fmt]
    tm, _ = _mats("powerlaw")
    o = _port_op(tm, fmt).obj
    assert o.has_er
    rng = np.random.default_rng(4)
    x1 = torch.as_tensor(rng.standard_normal(o.n_pad), dtype=torch.float32)
    xk = torch.as_tensor(rng.standard_normal((o.n_pad, 6)),
                         dtype=torch.float32)
    assert apply(o, x1).shape == (o.n_pad,)
    assert apply(o, x1[:, None]).shape == (o.n_pad, 1)
    assert calls == [spmv, spmv]
    del calls[:]
    y = apply(o, xk)
    assert calls == [fused]
    del calls[:]
    y_unfused = apply(o, xk, use_er_kernel=False)
    assert calls == [ell]
    torch.testing.assert_close(y_unfused, y, rtol=1e-5, atol=1e-5)
    # one column with use_er_kernel=False: the ELL-only SpMV kernel plus
    # the plain ER part, equal to the fused result
    del calls[:]
    y1 = apply(o, x1)
    y1_unfused = apply(o, x1, use_er_kernel=False)
    assert calls == [spmv, ell1] and y1_unfused.shape == (o.n_pad,)
    torch.testing.assert_close(y1_unfused, y1, rtol=1e-5, atol=1e-5)
    # an ER-free operator: the diagonal, ER-free under every partition
    n = tm.n
    d = from_coo(n, np.arange(n), np.arange(n, dtype=np.int32),
                 rng.standard_normal(n))
    od = _port_op(d, fmt).obj
    assert not od.has_er
    del calls[:]
    xd = torch.as_tensor(rng.standard_normal((od.n_pad, 6)),
                         dtype=torch.float32)
    yd = apply(od, xd)
    apply(od, xd[:, 0])
    assert calls == [ell, spmv]
    want = (d.to_dense() @ _port_op(d, fmt).from_space(xd).double().numpy())
    np.testing.assert_allclose(_port_op(d, fmt).from_space(yd).numpy(), want,
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# planning: k is part of the plan identity; sizing
# ---------------------------------------------------------------------------

def test_k_is_plan_identity_and_cpu_sizing_ignores_it():
    tm, _ = _mats("powerlaw")
    with pytest.raises(ValueError, match="k must be"):
        tapi.ExecutionConfig(format="ehyb", partition_method="bfs", k=0)
    cfg = dict(format="ehyb_packed", partition_method="bfs")
    c1, c16 = tapi.ExecutionConfig(**cfg), tapi.ExecutionConfig(**cfg, k=16)
    assert c1.token() != c16.token()
    cache = tapi.PlanCache()
    p1 = tplan(tm, execution=c1, device="cpu", cache=cache)
    p16 = tplan(tm, execution=c16, device="cpu", cache=cache)
    assert p1 is not p16
    assert (p1.n_parts, p1.vec_size) == (p16.n_parts, p16.vec_size)
    assert p16.partition is p1.partition      # same sizing on the CPU
    o1, o16 = p1.bind(tm).obj, p16.bind(tm).obj
    for f in dataclasses.fields(o1):
        a, b = getattr(o1, f.name), getattr(o16, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_card_sizing_on_h100_constants(monkeypatch):
    """elasticity3d(64)'s 786,432 rows on an H100 (132 SMs, 232,448 bytes
    of opt-in shared memory a block): a block holds min(k, 16) fp32 rhs
    columns of its x-slice and output tile."""
    plan_mod = importlib.import_module("repro_torch.api.plan")
    want = {1: (132, 5984), 8: (264, 3008), 16: (528, 1504),
            32: (528, 1504)}
    for k, sizing in want.items():
        assert choose_vec_size_cuda(786432, 4, 232448, 132,
                                    rhs=min(k, 16)) == sizing
    props = types.SimpleNamespace(shared_memory_per_block_optin=232448,
                                  multi_processor_count=132)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: props)
    for k, sizing in want.items():
        assert plan_mod.partition_sizing(786432, torch.device("cuda"),
                                         k) == sizing


# ---------------------------------------------------------------------------
# pruned layer: the port's pruned_linear against the JAX package's
# ---------------------------------------------------------------------------

def _layer_inputs(d_out, d_in, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d_out, d_in)), \
        rng.standard_normal((2, 3, d_in))


@pytest.mark.parametrize("shape", [(64, 256), (256, 64)])
def test_prune_to_csr_bit_identical(shape):
    w, _ = _layer_inputs(*shape)
    a, b = prune_to_csr(w, 0.2), jax_prune_to_csr(w, 0.2)
    assert a.n == b.n
    for f in ("indptr", "indices", "data"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
@pytest.mark.parametrize("shape", [(64, 256), (256, 64)])
def test_pruned_linear_matches_jax(shape, fmt):
    w, x = _layer_inputs(*shape)
    jl = japi.pruned_linear(w, 0.2, format="ehyb", partition_method="bfs",
                            k=6)
    want = np.asarray(jl(jnp.asarray(x, jnp.float32)), np.float64)
    oracle = x @ jax_prune_to_csr(w, 0.2).to_dense()[:shape[0], :shape[1]].T
    assert _err(want, oracle) < 5e-5
    layer = tapi.pruned_linear(w, 0.2, format=fmt, partition_method="bfs",
                               k=6, device="cpu")
    assert isinstance(layer, SparseLinear) and isinstance(layer,
                                                          torch.nn.Module)
    y = layer(x).detach()        # the layer's values require grad
    assert y.shape == (2, 3, shape[0]) and y.dtype == torch.float32
    assert _err(y.numpy(), want) < 5e-5
    assert _err(y.numpy(), oracle) < 5e-5
    # the permuted-space chain equals the original-space call
    xp = layer.to_permuted(x)
    assert xp.shape == (2, 3, layer.op.n_pad)
    torch.testing.assert_close(layer.from_permuted(layer(xp,
                                                         space="permuted")),
                               y, rtol=1e-5, atol=1e-5)
    back = layer.op.from_space(xp.reshape(-1, layer.op.n_pad).T)
    np.testing.assert_array_equal(
        back[: shape[1]].T.reshape(x.shape).numpy(), x.astype(np.float32))
    # the modeled bytes of the shared host build, whatever the format
    assert {**layer.bytes_vs_dense(), "format": "ehyb"} == jl.bytes_vs_dense()


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
@pytest.mark.parametrize("dt", sorted(TOL))
def test_converted_layer_matches_jax(fmt, dt):
    """The JAX layer carried across with its own tables: bf16 bit for bit,
    the same outputs as the JAX ehyb layer (fp32) and the dense oracle."""
    jdt, tdt, tol = TOL[dt]
    w, x = _layer_inputs(64, 256, seed=6)
    jl = japi.pruned_linear(w, 0.2, format=fmt, partition_method="bfs",
                            dtype=jdt)
    layer = convert.sparse_linear(
        *_leaves(jl.op.obj), csr=jl.csr, d_in=jl.d_in, d_out=jl.d_out,
        density=jl.density, partition_method="bfs", device="cpu")
    for f in ("er_p_vals", "er_vals") + (("packed_vals",) if fmt ==
                                         "ehyb_packed" else ("ell_vals",)):
        a = getattr(layer.op.obj, f)
        b = np.asarray(getattr(jl.op.obj, f))
        assert a.dtype == tdt
        np.testing.assert_array_equal(
            a.view(torch.uint16 if dt == "bf16" else torch.int32).numpy(),
            b.view(np.uint16 if dt == "bf16" else np.int32))
    with pytest.raises(ValueError, match="partition"):
        convert.sparse_linear(
            *_leaves(jl.op.obj), csr=jl.csr, d_in=jl.d_in, d_out=jl.d_out,
            density=jl.density, partition_method="natural", device="cpu")
    y = layer(x).detach()
    assert y.dtype == tdt and y.shape == (2, 3, 64)
    dense = jax_prune_to_csr(w, 0.2).to_dense()[:64, :256]
    assert _err(y.double().numpy(), x @ dense.T) < tol
    if dt == "f32":
        jref = japi.pruned_linear(w, 0.2, format="ehyb",
                                  partition_method="bfs")
        assert _err(y.numpy(), np.asarray(jref(jnp.asarray(x, jnp.float32)))
                    ) < tol


class _StubMesh:
    """A one-rank mesh the plan reads the geometry of (a mesh plan refuses
    a format with no shard hook before any collective)."""

    device_type = "cpu"
    mesh_dim_names = ("data",)
    mesh = torch.arange(1)

    def size(self, dim=0):
        return 1

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def test_layer_limits():
    w, x = _layer_inputs(32, 48)
    layer = EHYBLinear.from_dense(w, 0.3, device="cpu")
    assert type(layer) is EHYBLinear and layer.op.format == "ehyb"
    # update_values refills the layer's tables on its mask, in place
    y, perm = layer(x), layer.op.obj.perm
    layer3 = layer.update_values(3.0 * w)
    assert layer3 is layer and type(layer3) is EHYBLinear
    assert layer3.op.obj.perm is perm
    torch.testing.assert_close(layer3(x), 3.0 * y, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="no partition structure"):
        tapi.pruned_linear(w, 0.3, format="csr", partition_method="bfs",
                           mesh=_StubMesh(), device="cpu")
    # the format and the partition strategy autotuned, as in the reference
    auto = tapi.pruned_linear(w, 0.3, partition_method="bfs", device="cpu")
    assert auto.op.format == auto.op.tuning.format
    tuned_part = tapi.pruned_linear(w, 0.3, format="ehyb", device="cpu")
    assert tuned_part.op.plan.partition_tuning is not None
    for lay in (auto, tuned_part):
        torch.testing.assert_close(lay(x), y, rtol=1e-4, atol=1e-4)
    # transposed activations reach the apply as a strided view
    xt = torch.as_tensor(x[0].T.copy(), dtype=torch.float32).T
    assert not xt.is_contiguous()
    torch.testing.assert_close(layer(xt), layer(xt.contiguous()))

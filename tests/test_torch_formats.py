"""The five formats the autotuner brings — ``csr``, ``ell``, ``hyb``,
``ehyb_bucketed`` and ``dense`` — against the JAX package's.

Mirrors ``tests/test_spmv_formats.py`` and the all-formats conformance of
``tests/test_spmm.py``.  The reference's containers are built by its
registry and carried into the port through ``repro_torch.convert``: they
must equal the port's own builds, table for table.  The port's applies are
held against the reference's applies on the same tables in fp32 (the
reference's conformance tolerance, max|Δ| / max(max|y_ref|, 1) ≤ 1e-4) and
against numpy float64 oracles in fp32 (5e-5 of max|y|, the SpMM
conformance tolerance), bf16 (5e-2; the reference fails its own bf16 SpMM
conformance, so its bf16 output is no oracle) and fp64 (1e-12).  Rebinds
are bit-identical to fresh binds.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.autotune import registry as jreg
from repro.core import build_ehyb as jax_build_ehyb
from repro.core import ehyb as jehyb
from repro.core.matrices import poisson3d, powerlaw, unstructured
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.autotune import registry
from repro_torch.core import counters
from repro_torch.core import ehyb as tehyb
from repro_torch.core.matrices import SparseCSR, from_coo
from repro_torch.reliability import ReliabilityWarning, chaos
from repro_torch.reliability.guard import fallback_chain, reset_warned

# the module: ``repro_torch.core.spmv`` as an attribute is the legacy
# ``spmv`` function the package exports, as the reference's is
tspmv = importlib.import_module("repro_torch.core.spmv")

NEW = ["csr", "ell", "hyb", "ehyb_bucketed", "dense"]
MATS = {"stencil": lambda: poisson3d(6),
        "powerlaw": lambda: powerlaw(192, 6),
        "unstruct": lambda: unstructured(512, 8)}
KINDS = {"csr": "COODevice", "ell": "ELLDevice", "hyb": "HYBDevice",
         "ehyb_bucketed": "EHYBBucketsDevice", "dense": "DenseDevice"}
FAMILY_STATIC = ("n_pad", "n_parts", "vec_size", "has_er", "widths")


def port(m) -> SparseCSR:
    return SparseCSR(m.n, m.indptr, m.indices, m.data)


def rel(y, y_ref) -> float:
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    return float(np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1.0))


def carried(fmt, jobj, n):
    """The reference's container of ``fmt`` as the port's, via convert."""
    if fmt == "dense":
        return convert.device_container("DenseDevice",
                                        {"vals": np.asarray(jobj)},
                                        {"n": n}, device="cpu")
    static, leaves = {"n": jobj.n}, {}
    for f in dataclasses.fields(jobj):
        v = getattr(jobj, f.name)
        if f.name in FAMILY_STATIC:
            static[f.name] = v
        elif f.name in ("part_ids", "vals", "cols") and isinstance(v, tuple):
            leaves[f.name] = [np.asarray(a) for a in v]
        elif f.name not in ("n", "host"):
            leaves[f.name] = np.asarray(v)
    return convert.device_container(KINDS[fmt], leaves, static,
                                    device="cpu")


def both(fmt, m, jdt=jnp.float32, tdt=torch.float32):
    """(reference container, its apply, port container) of ``fmt`` for
    ``m``, the family on the same bfs host build (bit-identical)."""
    jobj, japply = jreg.build_format(fmt, m, jdt,
                                     {"ehyb": jax_build_ehyb(m)})
    tobj = registry.build_format(fmt, port(m), tdt,
                                 {"ehyb": tehyb.build_ehyb(port(m))},
                                 device="cpu")
    return jobj, japply, tobj


def assert_same_container(a, b):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        elif isinstance(x, tuple) and x and isinstance(x[0], torch.Tensor):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and torch.equal(u, v), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mat", list(MATS))
@pytest.mark.parametrize("fmt", NEW)
def test_carried_reference_tables_equal_the_ports_build(fmt, mat, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    m = MATS[mat]()
    jobj, _, tobj = both(fmt, m, jdt, tdt)
    assert_same_container(carried(fmt, jobj, m.n), tobj)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mat", list(MATS))
@pytest.mark.parametrize("fmt", NEW)
def test_applies_match_reference_and_float64(fmt, mat, k):
    m = MATS[mat]()
    rng = np.random.default_rng(k)
    x = rng.standard_normal((m.n, k))[:, 0] if k == 1 else \
        rng.standard_normal((m.n, k))
    oracle = m.to_dense() @ x
    scale = np.abs(oracle).max()
    spec = registry.get_format(fmt)
    # fp32: against the reference's apply on the same tables, and float64
    jobj, japply, tobj = both(fmt, m)
    y = spec.apply(tobj, torch.as_tensor(x, dtype=torch.float32))
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    y = y.double().numpy()
    assert rel(y, np.asarray(japply(jobj, jnp.asarray(x, jnp.float32)))) \
        < 1e-4
    assert np.abs(y - oracle).max() / scale < 5e-5
    # bf16 and fp64 against float64 oracles
    for tdt, tol in ((torch.bfloat16, 5e-2), (torch.float64, 1e-12)):
        obj = registry.build_format(fmt, port(m), tdt,
                                    {"ehyb": tehyb.build_ehyb(port(m))},
                                    device="cpu")
        yd = spec.apply(obj, torch.as_tensor(x, dtype=tdt))
        assert yd.dtype == tdt
        assert np.abs(yd.double().numpy() - oracle).max() / scale < tol
    if spec.permuted is not None:    # ehyb_bucketed: the permuted space
        xt = torch.as_tensor(x, dtype=torch.float32)
        xn, squeeze = tspmv._to_permuted(tobj, xt)
        yp = spec.permuted(tobj, xn[:, 0] if squeeze else xn)
        yo = tspmv._from_permuted(tobj, yp[:, None] if squeeze else yp,
                                  squeeze)
        assert np.abs(yo.double().numpy() - oracle).max() / scale < 5e-5


@pytest.mark.parametrize("fmt", NEW)
def test_chunked_applies_sum_the_same(fmt, monkeypatch):
    """The ELL-style applies accumulate over row (partition) chunks; the
    sums are the same whatever the chunk."""
    m = port(unstructured(512, 8))
    obj = registry.build_format(fmt, m, torch.float32,
                                {"ehyb": tehyb.build_ehyb(m)}, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((m.n, 3)),
                        dtype=torch.float32)
    y = registry.get_format(fmt).apply(obj, x)
    monkeypatch.setattr(tspmv, "_CHUNK_ELEMS", 97)
    torch.testing.assert_close(registry.get_format(fmt).apply(obj, x), y,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", NEW)
def test_rebind_is_bit_identical_to_a_fresh_bind(fmt, dtype):
    m1 = port(unstructured(512, 8))
    m2 = SparseCSR(m1.n, m1.indptr, m1.indices,
                   np.random.default_rng(9).standard_normal(m1.nnz))
    ex = tapi.ExecutionConfig(format=fmt, partition_method="bfs")
    p = tapi.plan(m1, execution=ex, device="cpu", cache=tapi.PlanCache())
    op1 = p.bind(m1, dtype=dtype)
    before = counters.snapshot()
    op2 = op1.update_values(m2)
    after = counters.snapshot()
    for c in ("partition", "build_ehyb", "build_buckets", "group_er"):
        assert after.get(c, 0) == before.get(c, 0), c
    fresh = tapi.plan(m1, execution=ex, device="cpu",
                      cache=tapi.PlanCache()).bind(m2, dtype=dtype)
    assert_same_container(op2.obj, fresh.obj)
    values = type(op2.obj).VALUE_FIELDS
    for f in dataclasses.fields(op2.obj):
        a = getattr(op2.obj, f.name)
        if f.name in values:
            assert a is not getattr(op1.obj, f.name)
        elif isinstance(a, (torch.Tensor, tuple)):
            assert a is getattr(op1.obj, f.name), f.name
    # a tensor bind scatters the same way, and reads back what it bound
    t = torch.as_tensor(m2.data).to(dtype)
    assert_same_container(p.bind(t, dtype=dtype).obj, fresh.obj)
    assert torch.equal(p.values_of(op2.obj), t)


def test_dense_sums_duplicate_entries():
    """A pattern with duplicate entries: the dense table sums them (in CSR
    order, the same at the first bind and a rebind); ``values_of`` reads
    each table entry once, so the guard's reference level and the
    gradient through the transpose plan agree with the product."""
    rng = np.random.default_rng(4)
    rows = np.array([0, 0, 0, 1, 2, 2, 3, 3, 3, 3], dtype=np.int64)
    cols = np.array([1, 1, 2, 0, 2, 2, 3, 0, 3, 3], dtype=np.int32)
    m = from_coo(4, rows, cols, rng.standard_normal(10),
                 sum_duplicates=False)
    assert m.nnz == 10
    dense = np.zeros((4, 4))
    np.add.at(dense, (np.repeat(np.arange(4), m.row_lengths()), m.indices),
              m.data)
    p = tapi.plan(m, execution=tapi.ExecutionConfig(format="dense"),
                  device="cpu", cache=tapi.PlanCache())
    op = p.bind(m, dtype=torch.float64)
    x = rng.standard_normal(4)
    np.testing.assert_allclose((op @ x).numpy(), dense @ x, rtol=1e-12)
    assert torch.equal(op.update_values(m).obj.vals, op.obj.vals)
    ref = fallback_chain(p, "apply")[-1][1]
    np.testing.assert_allclose(ref(op.obj, torch.as_tensor(x)).numpy(),
                               dense @ x, rtol=1e-12)
    xt = torch.tensor(x, requires_grad=True)
    (op @ xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), dense.T @ np.ones(4),
                               rtol=1e-12)


@pytest.mark.parametrize("fmt", NEW)
def test_values_and_gradients(fmt):
    """``values_of`` reads back the bound values; gradients w.r.t. the bound
    values and x against float64 oracles."""
    m = port(powerlaw(192, 6))
    p = tapi.plan(m, execution=tapi.ExecutionConfig(format=fmt),
                  device="cpu")
    vals = torch.tensor(m.data, requires_grad=True)
    op = p.bind(vals, dtype=torch.float64)
    x = torch.tensor(np.random.default_rng(2).standard_normal((m.n, 2)),
                     requires_grad=True)
    g = np.random.default_rng(3).standard_normal((m.n, 2))
    y = op @ x
    (y * torch.as_tensor(g)).sum().backward()
    rows = np.repeat(np.arange(m.n), m.row_lengths())
    xd = x.detach().numpy()
    np.testing.assert_allclose(vals.grad.numpy(),
                               (g[rows] * xd[m.indices]).sum(1), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), m.to_dense().T @ g,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(p.values_of(op.obj).numpy(), m.data)


@pytest.mark.parametrize("fmt", NEW)
def test_guard_chain_and_solve(fmt):
    """native -> reference, as in the JAX package; healthy outside chaos,
    downgraded to the reference under an injected fault; each solves."""
    reset_warned()
    m = port(poisson3d(6))
    p = tapi.plan(m, execution=tapi.ExecutionConfig(format=fmt),
                  device="cpu", cache=tapi.PlanCache())
    assert [n for n, _, _ in fallback_chain(p, "apply")] == \
        [f"{fmt}:native", "reference"]
    op = p.bind(m)
    x = np.random.default_rng(0).standard_normal(m.n)
    y = (op @ x).double().numpy()
    b = m.spmv(np.ones(m.n))
    r = op.solve(b, precond="jacobi", tol=1e-6)
    assert r.status == "converged"
    assert np.linalg.norm(m.spmv(r.x.double().numpy()) - b) \
        / np.linalg.norm(b) < 1e-5
    assert p.degraded == {}
    with chaos(kernel_failure=(f"{fmt}:native",)) as cfg:
        with pytest.warns(ReliabilityWarning, match="reference"):
            y2 = (op @ x).double().numpy()
        assert p.degraded == {"apply": "reference"}
    assert cfg.injected[f"kernel:{fmt}:native"] == 1
    assert rel(y2, y) < 1e-5
    if not op.supports_permuted:
        with pytest.raises(ValueError, match="permuted"):
            op.solve(b, space="permuted")
        with pytest.raises(ValueError, match="permuted"):
            op.n_pad


@pytest.mark.parametrize("n_buckets", [2, 4, 8])
def test_buckets_bit_identical_and_carried_through_refill(n_buckets):
    m = unstructured(512, 8)
    je, te = jax_build_ehyb(m), tehyb.build_ehyb(port(m))
    jb = jehyb.build_buckets(je, n_buckets=n_buckets)
    tb = tehyb.build_buckets(te, n_buckets=n_buckets)
    assert tb.widths == jb.widths
    for a, b in zip(tb.part_ids + tb.vals + tb.cols,
                    jb.part_ids + jb.vals + jb.cols):
        np.testing.assert_array_equal(a, b)
    for kw in ({}, {"space": "original", "k": 4}):
        want = jb.bytes_moved(4, **kw)
        assert want["interconnect"] == 0         # the dist term
        assert tb.bytes_moved(4, **kw) == want
    # the memoized views come along through a value refill
    memo = registry.memo_buckets(te, n_buckets)
    new = np.random.default_rng(1).standard_normal(m.nnz)
    counters.reset()
    te2 = te.refill(new)
    assert counters.snapshot().get("build_buckets", 0) == 0
    tb2 = registry.memo_buckets(te2, n_buckets)
    assert counters.snapshot().get("build_buckets", 0) == 0
    jb2 = jehyb.build_buckets(je.refill(new), n_buckets=n_buckets)
    for a, b in zip(tb2.vals, jb2.vals):
        np.testing.assert_array_equal(a, b)
    assert tb2.cols is memo.cols and tb2.base is te2

"""The port's value path: same pattern, new values, refill only.

Mirrors ``tests/test_refill.py`` and the rebind cases of
``tests/test_api.py`` on ``repro_torch`` (CPU): the host refill
(``EHYB.refill``/``PackedEHYB.refill``) bit-identical to the JAX package's,
a refilled container bit-identical to a fresh bind field by field (the
compact ER stream's ``er_s_vals`` included) with every structural tensor
shared, zero partition/build/pack/grouping passes on a rebind, the pattern
change rejected, ``build_ehyb`` never called, a solve reusing the
structure, ``SparseLinear.update_values``, the exact rebind a memo hit and
``update_values`` rejecting unknown keywords.  New values hold exact zeros,
which keep their slots.  Inputs come from numpy with a seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ehyb as jehyb
from repro.core import matrices as jmat
from repro.core import partition as jpart
from repro_torch import api as tapi
from repro_torch.api import ExecutionConfig, PlanCache, plan
from repro_torch.core import counters
from repro_torch.core import ehyb as tehyb
from repro_torch.core import matrices as tmat
from repro_torch.core import partition as tpart
from repro_torch.core.matrices import SUITE, SparseCSR, poisson3d, powerlaw
from repro_torch.core.spmv import EHYBDevice, EHYBPackedDevice

STRUCTURE_COUNTERS = ("partition", "build_ehyb", "pack_staircase",
                      "group_er")
VALUE_FIELDS = {EHYBDevice: ("ell_vals", "er_vals", "er_p_vals",
                             "er_s_vals"),
                EHYBPackedDevice: ("packed_vals", "er_vals", "er_p_vals",
                                   "er_s_vals")}


def new_values(m, seed: int = 7) -> np.ndarray:
    """Seeded new values on ``m``'s pattern, every fifth one an exact zero
    (a stored zero keeps its slot)."""
    data = np.random.default_rng(seed).standard_normal(m.nnz)
    data[::5] = 0.0
    return data


def with_values(m, data) -> SparseCSR:
    return SparseCSR(m.n, m.indptr, m.indices, data)


def structure_work(before: dict, after: dict) -> dict:
    return {c: after.get(c, 0) - before.get(c, 0) for c in STRUCTURE_COUNTERS
            if after.get(c, 0) != before.get(c, 0)}


def pinned(fmt, **kw):
    return ExecutionConfig(format=fmt, partition_method="bfs", **kw)


@pytest.mark.parametrize("name", list(SUITE))
def test_host_refill_bit_identical_to_jax(name):
    """``EHYB.refill`` and ``PackedEHYB.refill`` (through the memoized
    packing and ER grouping) equal the JAX package's, array for array, and
    a fresh build of the new values."""
    tm, jm = tmat.SUITE[name](), jmat.SUITE[name]()
    n_parts, vec_size = jpart.choose_vec_size(jm.n)
    kw = dict(method="bfs", n_parts=n_parts, vec_size=vec_size)
    tpa = tpart.make_partition(tm, **kw)
    te = tehyb.build_ehyb(tm, part=tpa)
    je = jehyb.build_ehyb(jm, part=jpart.make_partition(jm, **kw))
    tehyb.group_er_by_partition(te)
    jehyb.group_er_by_partition(je)
    te._packed = tehyb.pack_staircase(te)
    je._packed = jehyb.pack_staircase(je)
    tehyb.er_stream(te)
    data = new_values(tm)
    t2, j2 = te.refill(data), je.refill(data)
    fresh = tehyb.build_ehyb(with_values(tm, data), part=tpa)
    fresh_g = tehyb.group_er_by_partition(fresh)
    fresh_pk = tehyb.pack_staircase(fresh)
    got = {"ell_vals": t2.ell_vals, "er_vals": t2.er_vals,
           "er_p_vals": t2._er_grouped["er_p_vals"],
           "packed_vals": t2._packed.packed_vals}
    want = {"ell_vals": j2.ell_vals, "er_vals": j2.er_vals,
            "er_p_vals": j2._er_grouped["er_p_vals"],
            "packed_vals": j2._packed.packed_vals}
    built = {"ell_vals": fresh.ell_vals, "er_vals": fresh.er_vals,
             "er_p_vals": fresh_g["er_p_vals"],
             "packed_vals": fresh_pk.packed_vals}
    for f in got:
        assert got[f].dtype == want[f].dtype, (name, f)
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_array_equal(got[f], built[f], err_msg=f)
    # pattern arrays and views shared, not recomputed
    assert t2.ell_cols is te.ell_cols and t2.fill_plan is te.fill_plan
    assert t2._er_stream is te._er_stream
    assert t2._packed.base is t2
    assert t2._packed.packed_cols is te._packed.packed_cols


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
@pytest.mark.parametrize("name", list(SUITE))
def test_refilled_container_bit_identical_to_fresh_bind(name, fmt, dtype):
    m1 = SUITE[name]()
    m2 = with_values(m1, new_values(m1))
    p = plan(m1, execution=pinned(fmt), device="cpu", cache=PlanCache())
    op1 = p.bind(m1, dtype=dtype)
    before = counters.snapshot()
    op2 = op1.update_values(m2)
    after = counters.snapshot()
    assert structure_work(before, after) == {}
    # the values are scattered on the device: no host refill runs either
    assert after.get("ehyb_refill", 0) == before.get("ehyb_refill", 0)
    fresh = plan(m1, execution=pinned(fmt), device="cpu",
                 cache=PlanCache()).bind(m2, dtype=dtype)
    obj, ref, old = op2.obj, fresh.obj, op1.obj
    assert type(obj) is type(ref)
    values = VALUE_FIELDS[type(obj)]
    for f in dataclasses.fields(obj):
        a, b, c = (getattr(o, f.name) for o in (obj, ref, old))
        if not isinstance(a, torch.Tensor):
            assert a == b, f.name
        elif f.name in values:
            assert a.dtype == b.dtype == dtype, f.name
            assert torch.equal(a, b), f.name
            assert a is not c, f.name
        else:                    # structure: the same object, not uploaded
            assert a is c and torch.equal(a, b), f.name
    # the stream's values are the new grouped tiles gathered at pos
    pos = torch.from_numpy(tehyb.er_stream(p.host_build(m2))["pos"])
    assert torch.equal(obj.er_s_vals,
                       obj.er_p_vals.reshape(-1).index_select(0, pos))
    assert torch.equal(p.values_of(obj), torch.as_tensor(m2.data).to(dtype))


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
def test_refilled_operator_computes_the_new_matrix(fmt):
    m1 = powerlaw(256, 4)
    m2 = with_values(m1, new_values(m1))
    op2 = plan(m1, execution=pinned(fmt), device="cpu").bind(m1) \
        .update_values(m2)
    x = np.random.default_rng(0).standard_normal(m1.n)
    np.testing.assert_allclose((op2 @ x).double().numpy(), m2.spmv(x),
                               rtol=5e-5, atol=5e-5)
    xs = np.random.default_rng(1).standard_normal((m1.n, 4))
    np.testing.assert_allclose((op2 @ xs).double().numpy(),
                               m2.to_dense() @ xs, rtol=5e-5, atol=5e-5)


def test_update_values_rejects_pattern_change():
    m = poisson3d(6)
    op = plan(m, execution=pinned("ehyb_packed"), device="cpu").bind(m)
    with pytest.raises(ValueError):
        op.update_values(poisson3d(8))
    with pytest.raises(ValueError):
        op.update_values(np.ones(m.nnz + 1))
    other = SparseCSR(m.n, m.indptr, np.roll(m.indices, 1), m.data)
    with pytest.raises(ValueError):
        op.update_values(other)


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
def test_update_values_rejects_non_finite(fmt):
    m = poisson3d(6)
    op = plan(m, execution=pinned(fmt), device="cpu").bind(m)
    bad = m.data.copy()
    bad[3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        op.update_values(bad)
    with pytest.raises(ValueError, match="non-finite"):
        op.update_values(torch.as_tensor(bad))


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
def test_refill_triggers_zero_partitioning_or_packing(fmt):
    m1 = powerlaw(256, 4)
    m2 = with_values(m1, new_values(m1))
    op1 = plan(m1, execution=pinned(fmt), device="cpu",
               cache=PlanCache()).bind(m1)
    before = counters.snapshot()
    op2 = op1.update_values(m2)
    op3 = op2.update_values(m2.data * 3.0)
    after = counters.snapshot()
    assert structure_work(before, after) == {}
    assert after.get("ehyb_refill", 0) == before.get("ehyb_refill", 0)
    main = "packed_cols" if fmt == "ehyb_packed" else "ell_cols"
    for op in (op2, op3):
        assert getattr(op.obj, main) is getattr(op1.obj, main)
        assert op.obj.perm is op1.obj.perm
        assert op.obj.er_s_cols is op1.obj.er_s_cols
        assert op.plan is op1.plan


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
def test_refill_never_calls_build_ehyb(monkeypatch, fmt):
    """The whole update path works with build_ehyb gone."""
    import importlib

    plan_mod = importlib.import_module("repro_torch.api.plan")
    ehyb_mod = importlib.import_module("repro_torch.core.ehyb")

    m1 = poisson3d(6)
    m2 = with_values(m1, new_values(m1))
    op1 = plan(m1, execution=pinned(fmt), device="cpu",
               cache=PlanCache()).bind(m1)

    def boom(*a, **k):
        raise AssertionError("build_ehyb must not run on a value-only "
                             "update")

    monkeypatch.setattr(plan_mod, "build_ehyb", boom)
    monkeypatch.setattr(ehyb_mod, "build_ehyb", boom)
    monkeypatch.setattr(ehyb_mod, "pack_staircase", boom)
    op2 = op1.update_values(m2)
    x = np.random.default_rng(0).standard_normal(m1.n)
    np.testing.assert_allclose((op2 @ x).double().numpy(), m2.spmv(x),
                               rtol=5e-5, atol=5e-5)


def test_solve_reuses_structure_across_value_updates():
    """Transient-FEM shape: a re-solve with new values on the fixed pattern
    re-runs no structure pass and sees the new matrix (2A: x halves)."""
    m1 = poisson3d(6)
    m2 = with_values(m1, m1.data * 2.0)
    b = np.random.default_rng(2).standard_normal(m1.n)
    op1 = plan(m1, execution=pinned("ehyb_packed"), device="cpu",
               cache=PlanCache()).bind(m1)
    r1 = op1.solve(b, tol=1e-8)
    before = counters.snapshot()
    r2 = op1.update_values(m2).solve(b, tol=1e-8)
    after = counters.snapshot()
    assert structure_work(before, after) == {}
    assert r1.status == r2.status == "converged"
    np.testing.assert_allclose(r2.x.numpy(), r1.x.numpy() / 2.0, rtol=1e-4,
                               atol=1e-5)
    assert op1.plan.degraded == {}


def test_sparse_linear_update_values_refills():
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((24, 48))
    lin = tapi.pruned_linear(w1, 0.25, format="ehyb_packed",
                             partition_method="bfs", device="cpu")
    x = rng.standard_normal((2, 48))
    with torch.no_grad():
        y = lin(x)
    param, obj1 = lin.values, lin.op.obj
    vals1 = param.detach().clone()
    before = counters.snapshot()
    lin2 = lin.update_values(w1 * 3.0)
    after = counters.snapshot()
    assert structure_work(before, after) == {}
    # in place: the same layer and the same parameter, now the new weights
    assert lin2 is lin and lin.values is param
    with torch.no_grad():
        y2 = lin2(x)
    torch.testing.assert_close(y2, 3.0 * y, rtol=1e-4, atol=1e-4)
    assert lin2.ehyb is not None and lin2.op.obj.perm is obj1.perm
    assert lin2.op.obj is not obj1
    torch.testing.assert_close(lin2.values.detach(), 3.0 * vals1)
    # the JAX layer's update on the same mask
    jl = japi.pruned_linear(w1, 0.25, format="ehyb",
                            partition_method="bfs").update_values(w1 * 3.0)
    want = np.asarray(jl(jnp.asarray(x, jnp.float32)), np.float64)
    np.testing.assert_allclose(y2.double().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError):
        lin.update_values(w1.T)


def test_rebind_is_refill_only():
    m1 = poisson3d(6)
    m2 = with_values(m1, m1.data * 2.5)
    p = plan(m1, execution=pinned("ehyb"), device="cpu", cache=PlanCache())
    op1 = p.bind(m1)
    before = counters.snapshot()
    op2 = p.bind(m2)
    after = counters.snapshot()
    assert structure_work(before, after) == {}
    assert op2.obj.perm is op1.obj.perm
    assert op2.obj.ell_vals is not op1.obj.ell_vals
    x = torch.ones(m1.n)
    torch.testing.assert_close(op2 @ x, 2.5 * (op1 @ x), rtol=1e-5,
                               atol=1e-5)


def test_update_values_and_exact_rebind_identity():
    m1 = poisson3d(6)
    p = plan(m1, execution=pinned("ehyb_packed"), device="cpu",
             cache=PlanCache())
    op1 = p.bind(m1)
    op2 = p.bind(m1)              # exact value hit: same container
    assert op2.obj is op1.obj
    op3 = op1.update_values(with_values(m1, m1.data * 3.0))
    assert op3.plan is p and op3.obj.perm is op1.obj.perm
    assert op3.obj is not op1.obj
    # the guards are the plan's: a refill resolves nothing anew
    op1 @ torch.ones(m1.n)
    guards = dict(p._guards)
    op3 @ torch.ones(m1.n)
    assert p._guards == guards and p.degraded == {}


def test_update_values_rejects_unknown_kwargs():
    m = poisson3d(6)
    op = plan(m, execution=pinned("ehyb_packed"), device="cpu").bind(m)
    with pytest.raises(TypeError, match="dytpe"):
        op.update_values(with_values(m, m.data * 2.0), dytpe=torch.float64)
    op2 = op.update_values(with_values(m, m.data * 2.0))
    assert op2.plan is op.plan and op2.dtype == op.dtype


def test_bind_at_another_dtype_shares_the_structure():
    m = powerlaw(256, 4)
    p = plan(m, execution=pinned("ehyb_packed"), device="cpu",
             cache=PlanCache())
    op32 = p.bind(m)
    before = counters.snapshot()
    op16 = p.bind(m, dtype=torch.bfloat16)
    assert structure_work(before, counters.snapshot()) == {}
    assert op16.obj.packed_cols is op32.obj.packed_cols
    assert op16.obj.packed_vals.dtype == torch.bfloat16
    fresh = plan(m, execution=pinned("ehyb_packed"), device="cpu",
                 cache=PlanCache()).bind(m, dtype=torch.bfloat16)
    for f in VALUE_FIELDS[EHYBPackedDevice]:
        assert torch.equal(getattr(op16.obj, f), getattr(fresh.obj, f)), f


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
def test_tensor_bind_equals_host_bind(fmt):
    """``plan.bind(tensor)`` scatters on the device into a container equal
    to the host bind's, field by field, with the structure shared."""
    m1 = powerlaw(256, 4)
    data = new_values(m1)
    p = plan(m1, execution=pinned(fmt), device="cpu", cache=PlanCache())
    op1 = p.bind(m1)
    before = counters.snapshot()
    opt = p.bind(torch.as_tensor(data))
    assert structure_work(before, counters.snapshot()) == {}
    oph = p.bind(data)
    for f in dataclasses.fields(opt.obj):
        a, b = getattr(opt.obj, f.name), getattr(oph.obj, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
            if f.name not in VALUE_FIELDS[type(opt.obj)]:
                assert a is getattr(op1.obj, f.name), f.name


def test_plan_and_cache_hold_no_stale_values():
    """The plan keeps its containers' structure and a weak reference to
    the last one, never a value table of its own; the host cache keeps one
    build a pattern, however many value sets were built."""
    import gc

    m = poisson3d(6)
    cache = PlanCache()
    p = plan(m, execution=pinned("ehyb_packed"), device="cpu", cache=cache)
    op1 = p.bind(m)
    for f in VALUE_FIELDS[EHYBPackedDevice]:
        assert getattr(p._structure, f).untyped_storage().nbytes() <= 8, f
        assert getattr(p._structure, f).shape == getattr(op1.obj, f).shape
    ref = p._last[torch.float32][0]
    assert ref() is op1.obj
    del op1
    gc.collect()
    assert ref() is None
    op2 = p.bind(m)                  # rebuilt by a scatter, not the host
    assert op2.obj.packed_cols is p._structure.packed_cols
    for s in (2.0, 3.0, 4.0):
        p.host_build(with_values(m, m.data * s))
    assert len(cache._host) == 1

"""``repro_torch.dist`` against ``repro.dist`` — mirrors ``tests/test_dist.py``.

Host level: the halo plan bit-identical to the reference's, field by field;
the numpy simulation of the port's plan against the CSR product; the
partition padding; the device fetch layout; every rank's shard applied in
one process with the exchange replayed by indexing (and a NaN in x reaching
exactly the rows the CSR product makes NaN); the ``"dist"`` cost model and
decisions against the reference's; the shim's audited exports.

Multi-rank: ``tests/torch_dist_worker.py`` run as 4 (and once 8) processes
in a gloo group, rendezvous through a ``FileStore`` in ``tmp_path`` (no
port to collide on under xdist), each spawn joined with a 120 s timeout.
The children import no jax.  They hold the sharded apply and solve against
the CSR product and the port's local plan (the reference's bounds of
``tests/test_dist.py:361-374``), not against the reference's
``test_dist_equivalence_sweep``, which fails on the installed jax.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import autotune as jat
from repro.api import ExecutionConfig as JExecutionConfig
from repro.api import plan as jplan
from repro.core import build_ehyb as jbuild_ehyb
from repro.core.matrices import SUITE as JSUITE
from repro.core.matrices import poisson3d, powerlaw
from repro.core.partition import make_partition as jmake_partition
from repro.dist import halo as jhalo
from repro_torch import autotune as tat
from repro_torch.api import ExecutionConfig, plan
from repro_torch.api.config import resolve_context
from repro_torch.core.ehyb import build_ehyb
from repro_torch.core.matrices import SparseCSR
from repro_torch.core.partition import make_partition
from repro_torch.dist import halo as thalo
from repro_torch.dist.operator import (_shards_from_ehyb, replay_apply,
                                       shard_of)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_dist_worker.py")
JOIN_TIMEOUT = 120


def port(m) -> SparseCSR:
    """The reference's matrix as the port's (the same numpy arrays)."""
    return SparseCSR(m.n, m.indptr, m.indices, m.data)


def _matrix(name: str):
    return {"poisson": lambda: poisson3d(10),
            "powerlaw": lambda: powerlaw(1024, 6, seed=7)}[name]()


# ---------------------------------------------------------------------------
# host level: the plan, bit for bit
# ---------------------------------------------------------------------------

def assert_same_plan(tp, jp) -> None:
    for f in dataclasses.fields(jp):
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b and type(a) is type(b), (f.name, a, b)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("mat", ["poisson", "powerlaw"])
def test_halo_plan_bit_identical_to_reference(mat, n_dev):
    """Every array of the port's HaloPlan equals the reference's for the
    same EHYB, and so do ``ehyb_halo_words`` and ``partition_halo_words``."""
    m = _matrix(mat)
    je, te = jbuild_ehyb(m), build_ehyb(port(m))
    assert_same_plan(thalo.build_halo_plan(te, n_dev),
                     jhalo.build_halo_plan(je, n_dev))
    assert thalo.ehyb_halo_words(te, n_dev) == \
        jhalo.ehyb_halo_words(je, n_dev)
    for method in ("natural", "bfs", "hub"):
        jpart = jmake_partition(m, method=method)
        tpart = make_partition(port(m), method=method)
        assert thalo.partition_halo_words(port(m), tpart, n_dev) == \
            jhalo.partition_halo_words(m, jpart, n_dev)


def simulate_plan(e, plan_, x_new: np.ndarray) -> np.ndarray:
    """The sharded apply replayed in plain numpy from the host plan (the
    reference test's ``simulate_plan``)."""
    L, nd, S = plan_.local_size, plan_.n_dev, plan_.seg_len
    x = np.zeros(plan_.n_pad_dist)
    x[: e.n_pad] = x_new
    fer_vals = plan_.fill_fetch(e.er_vals)
    pe_vals = plan_.fill_push(e.er_vals)
    y = np.zeros(plan_.n_pad_dist)
    P_, V = e.n_parts, e.vec_size
    base = (np.arange(P_) * V)[:, None, None]
    g = x[base + e.ell_cols.astype(np.int64)]
    y[: P_ * V] = np.einsum("pvw,pvw->pv", e.ell_vals, g).reshape(-1)
    if not plan_.has_er:
        return y
    buf = np.zeros((nd, nd, S))
    for s in range(nd):
        buf[s] = x[s * L + plan_.send_idx[s]] * plan_.send_mask[s]
        contrib = pe_vals[s] * x[s * L + plan_.pe_cols[s]] * plan_.pe_mask[s]
        np.add.at(buf[s].reshape(-1), plan_.pe_dst[s], contrib)
    for d in range(nd):
        recv = buf[:, d].reshape(-1)
        x_ext = np.concatenate([x[d * L: (d + 1) * L],
                                recv[plan_.recv_sel[d]]])
        ye = np.einsum("ew,ew->e", fer_vals[d], x_ext[plan_.fer_cols[d]])
        np.add.at(y, d * L + plan_.fer_rows[d], ye)
        part = recv[plan_.rp_sel[d]] * plan_.rp_mask[d]
        np.add.at(y, d * L + plan_.rp_rows[d], part)
    return y


def reference_permuted(m, e, plan_, x_new: np.ndarray) -> np.ndarray:
    x_o = x_new[np.asarray(e.inv_perm[: m.n])]
    y_ref = np.zeros(plan_.n_pad_dist)
    live = e.perm < m.n
    y_ref[: e.n_pad][live] = m.spmv(x_o)[e.perm[live]]
    return y_ref


@pytest.mark.parametrize("mat,n_dev", [("poisson", 4), ("poisson", 8),
                                       ("powerlaw", 4), ("powerlaw", 8)])
def test_halo_plan_numpy_simulation(mat, n_dev, rng):
    """The port's planned exchange, replayed in numpy, reproduces A@x —
    including the y-push direction powerlaw matrices trigger."""
    m = port(_matrix(mat))
    e = build_ehyb(m)
    hp = thalo.build_halo_plan(e, n_dev)
    x_new = np.zeros(e.n_pad)
    x_new[np.asarray(e.inv_perm[: m.n])] = rng.standard_normal(m.n)
    np.testing.assert_allclose(simulate_plan(e, hp, x_new),
                               reference_permuted(m, e, hp, x_new),
                               rtol=1e-10, atol=1e-10)
    if mat == "powerlaw":
        assert hp.has_push
    assert hp.halo_words < hp.allgather_words
    assert hp.halo_words == int(hp.counts_fetch.sum() + hp.counts_push.sum())
    assert thalo.ehyb_halo_words(e, n_dev) == hp.halo_words


def _padding_case():
    m = poisson3d(9)
    vec = -(-m.n // 3 // 8) * 8
    return m, jbuild_ehyb(m, n_parts=3, vec_size=vec), \
        build_ehyb(port(m), n_parts=3, vec_size=vec)


def test_halo_plan_partition_padding(rng):
    """n_parts % n_dev != 0 pads with empty partitions: the plan equals the
    reference's bit for bit, and its simulation is exact."""
    m, je, te = _padding_case()
    hp = thalo.build_halo_plan(te, 2)
    assert_same_plan(hp, jhalo.build_halo_plan(je, 2))
    assert hp.n_parts_pad == 4 and hp.parts_per_dev == 2
    assert hp.n_pad_dist == 4 * te.vec_size > te.n_pad
    x_new = np.zeros(te.n_pad)
    x_new[np.asarray(te.inv_perm[: m.n])] = rng.standard_normal(m.n)
    np.testing.assert_allclose(simulate_plan(te, hp, x_new),
                               reference_permuted(port(m), te, hp, x_new),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_fetch_layout_is_width_sorted_and_live(n_dev):
    """Each rank's device fetch table holds its live rows only, in
    non-increasing live width, with ``col_rows`` from the pattern, and
    carries the host table's entries (its value fill and columns)."""
    e = build_ehyb(port(_matrix("powerlaw")))
    hp = thalo.build_halo_plan(e, n_dev)
    rf, wf = hp.fer_cols.shape[1:]
    fill = hp.fill_fetch(e.er_vals)
    n_rows = 0
    for d in range(n_dev):
        fl = thalo.fetch_layout(hp, d)
        widths = (fl["col_rows"][None, :]
                  > np.arange(len(fl["rows"]))[:, None]).sum(axis=1)
        assert (np.diff(widths) <= 0).all() and (widths > 0).all()
        assert len(np.unique(fl["fer_rows"])) == len(fl["rows"])
        vals = np.zeros(fl["cols"].size)
        vals[fl["dst"]] = e.er_vals.reshape(-1)[fl["src"]]
        vals = vals.reshape(fl["cols"].shape)
        for i, slot in enumerate(fl["rows"]):
            w = widths[i]
            np.testing.assert_array_equal(vals[i, :w], fill[d, slot, :w])
            np.testing.assert_array_equal(fl["cols"][i, :w],
                                          hp.fer_cols[d, slot, :w])
            assert not fill[d, slot, w:].any()
        n_rows += len(fl["rows"])
    assert n_rows == len(np.unique(hp.fer_dst // wf))


# ---------------------------------------------------------------------------
# every rank's shard in one process: the exchange replayed by indexing
# ---------------------------------------------------------------------------

def _shards(e, n_dev, dtype=torch.float32):
    hp = thalo.build_halo_plan(e, n_dev)
    return hp, [_shards_from_ehyb(e, hp, dtype, torch.device("cpu"), r)[0]
                for r in range(n_dev)]


def _replay(shards, x, dtype=torch.float32, plain=False):
    xs = [shard_of(o, torch.as_tensor(x, dtype=dtype))[:, None]
          for o in shards]
    y = torch.cat(replay_apply(shards, xs, plain=plain))[:, 0]
    return y[shards[0].inv_perm[: shards[0].n]].double().numpy()


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("mat", ["poisson", "powerlaw"])
def test_replayed_shards_match_the_csr_product(mat, n_dev, rng):
    """Every rank's ``_local_apply`` (the ELL-only stage, the send buffer,
    the fetch table through #6's wrapper, the pushed partials), the
    exchange replayed by indexing, equals the CSR product: fp32 within
    2e-4 relative, fp64 within 1e-10; the plain stages agree."""
    m = port(_matrix(mat))
    e = build_ehyb(m)
    x = rng.standard_normal(m.n)
    y_ref = m.spmv(x)
    hp, sh = _shards(e, n_dev)
    scale = np.abs(y_ref).max()
    assert np.abs(_replay(sh, x) - y_ref).max() <= 2e-4 * scale
    np.testing.assert_array_equal(_replay(sh, x, plain=True),
                                  _replay(sh, x))
    _, sh64 = _shards(e, n_dev, torch.float64)
    np.testing.assert_allclose(_replay(sh64, x, torch.float64), y_ref,
                               rtol=1e-10, atol=1e-10)
    assert sum(o.fer_rows.numel() for o in sh) == \
        len(np.unique(hp.fer_dst // hp.fer_cols.shape[2]))


def test_replayed_shards_with_padded_partitions(rng):
    m, _, te = _padding_case()
    _, sh = _shards(te, 2)
    assert sh[1].ell_vals.shape[0] == 2 and not sh[1].col_rows[1].any()
    x = rng.standard_normal(m.n)
    y_ref = m.spmv(x)
    assert np.abs(_replay(sh, x) - y_ref).max() <= 2e-4 * np.abs(y_ref).max()


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_apply_nan_reaches_exactly_the_csr_rows(n_dev):
    """One NaN in x: every row the CSR product makes NaN is NaN, and no
    other — the shards read live entries only, so a padded slot (value 0,
    column 0) never spreads it; the columns include the one at x_new[0]."""
    for mat in ("poisson", "powerlaw"):
        m = port(_matrix(mat))
        e = build_ehyb(m)
        _, sh = _shards(e, n_dev)
        x = np.random.default_rng(1).standard_normal(m.n)
        first = int(e.perm[0]) if e.perm[0] < m.n else 0
        for col in sorted({first, 0, m.n // 2, m.n - 1}):
            xn = x.copy()
            xn[col] = np.nan
            want = np.isnan(m.spmv(xn))
            got = np.isnan(_replay(sh, xn))
            np.testing.assert_array_equal(got, want, err_msg=f"{mat} {col}")


# ---------------------------------------------------------------------------
# the "dist" cost model and decisions against the reference
# ---------------------------------------------------------------------------

def test_dist_cost_model_interconnect():
    """context="dist" = solver-context bytes + the interconnect term: halo
    words for shardable formats, the all-gather penalty otherwise — equal
    to the reference's numbers."""
    m = poisson3d(12)
    te, je = build_ehyb(port(m)), jbuild_ehyb(m)
    for fmt in ("ehyb", "ehyb_packed", "ehyb_bucketed", "csr", "ell"):
        for k in (1, 4):
            got = tat.estimate_bytes(port(m), fmt, 4,
                                     {"ehyb": te, "n_dev": 4},
                                     context="dist", k=k)
            want = jat.estimate_bytes(m, fmt, 4, {"ehyb": je, "n_dev": 4},
                                      context="dist", k=k)
            assert got == want, (fmt, k)
            terms = tat.estimate_terms(port(m), fmt, 4,
                                       {"ehyb": te, "n_dev": 4},
                                       context="dist", k=k)
            assert terms == jat.estimate_terms(
                m, fmt, 4, {"ehyb": je, "n_dev": 4}, context="dist", k=k)
            assert sum(terms.values()) == got
    solver_b = tat.estimate_bytes(port(m), "ehyb", 4, {"ehyb": te},
                                  context="solver")
    assert tat.estimate_bytes(port(m), "ehyb", 4, {"ehyb": te, "n_dev": 4},
                              context="dist") == \
        solver_b + 4 * thalo.ehyb_halo_words(te, 4)
    assert tat.estimate_bytes(
        port(m), "csr", 4, {"n_dev": 4}, context="dist") == \
        tat.estimate_bytes(port(m), "csr", 4, {}, context="solver") \
        + tat.allgather_penalty_bytes(m.n, 4, 4)
    with pytest.raises(ValueError, match="mesh size"):
        tat.estimate_bytes(port(m), "ehyb", 4, {"ehyb": te}, context="dist")
    with pytest.raises(ValueError, match="n_dev"):
        tat.autotune(port(m), context="dist", n_dev=1, device="cpu")
    with pytest.raises(ValueError, match="n_dev >= 2"):
        tat.partition_cost(port(m), make_partition(port(m)), 4,
                           context="dist", n_dev=1)


@pytest.mark.parametrize("name", ["poisson3d_16", "elasticity_8",
                                  "unstruct_4k", "powerlaw_4k"])
def test_dist_decisions_equal_reference(name):
    """The tuner in the "dist" context — format over the shardable
    candidates and partition strategy, with their tables — decides as the
    reference does on the CPU."""
    m = JSUITE[name]()
    shardable = tuple(f for f in tat.available_formats()
                      if tat.get_format(f).shard is not None)
    assert shardable == tuple(f for f in jat.available_formats()
                              if jat.get_format(f).shard is not None)
    for n_dev in (2, 4):
        tr = tat.autotune_partition(port(m), context="dist", n_dev=n_dev)
        jr = jat.autotune_partition(m, context="dist", n_dev=n_dev)
        assert (tr.strategy, tr.modeled_bytes, tr.halo_words) == \
            (jr.strategy, jr.modeled_bytes, jr.halo_words)
        tt = tat.autotune(port(m), context="dist", n_dev=n_dev,
                          candidates=shardable, device="cpu")
        jt = jat.autotune(m, context="dist", n_dev=n_dev,
                          candidates=shardable)
        assert (tt.format, tt.modeled_bytes) == (jt.format, jt.modeled_bytes)


class StubMesh:
    """A mesh the plan reads the geometry of and never communicates on
    (the reference's ``Plan._create`` reads only ``mesh.shape``)."""

    device_type = "cpu"
    mesh_dim_names = ("data",)

    def __init__(self, n: int):
        self.n = n
        self.shape = {"data": n}
        self.mesh = torch.arange(n)

    def size(self, dim=0):
        return self.n

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def test_build_sharded_rejects_unshardable_format():
    """A mesh plan takes only the EHYB family, with the reference's
    message; "dist" needs a multi-rank mesh."""
    m = port(poisson3d(8))
    with pytest.raises(ValueError, match="no partition structure"):
        plan(m, mesh=StubMesh(2), execution=ExecutionConfig(format="csr"))
    with pytest.raises(ValueError, match="no partition structure"):
        jplan(poisson3d(8), mesh=StubMesh(2),
              execution=JExecutionConfig(format="csr"))
    with pytest.raises(ValueError, match="multi-rank mesh"):
        plan(m, execution=ExecutionConfig(workload="dist"), device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        resolve_context("spmv", True, 4)
    assert resolve_context("auto", True, 4) == "dist"
    assert resolve_context("dist", True, 1) == "solver"
    assert resolve_context("auto", True, 1) == "solver"
    assert resolve_context("auto", False) == "spmv"
    with pytest.raises(ValueError, match="axis"):
        plan(m, mesh=StubMesh(2), mesh_axis="model")


def test_dist_spmv_shim_exports_are_audited():
    """The shim forwards only names that exist in ``repro_torch.dist``,
    with a DeprecationWarning on access, imports without warning, and the
    pre-halo API stays gone; the package exports the reference's names."""
    import importlib
    import warnings

    import repro.dist as jdist
    import repro_torch.dist as tdist

    assert tdist.__all__ == jdist.__all__
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mod = importlib.reload(
            importlib.import_module("repro_torch.core.dist_spmv"))
        for name in mod.__all__:
            assert getattr(mod, name) is not None
    jmod = importlib.import_module("repro.core.dist_spmv")
    assert mod._FORWARDED == jmod._FORWARDED and mod.__all__ == jmod.__all__
    for name in mod._FORWARDED:
        assert hasattr(tdist, name), f"stale forwarded export {name!r}"
        with pytest.warns(DeprecationWarning, match=name):
            assert getattr(mod, name) is getattr(tdist, name)
    with pytest.raises(AttributeError):
        mod.all_gather_spmv


# ---------------------------------------------------------------------------
# multi-rank: gloo groups of spawned processes
# ---------------------------------------------------------------------------

def run_ranks(scenario: str, world: int, tmp: Path) -> dict:
    """Run ``world`` worker processes of ``scenario`` in one gloo group;
    the numbers rank 0 wrote.  A hang fails here after the join timeout
    (every process killed) instead of eating the run's clock."""
    store, out = tmp / "store", tmp / "out.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), scenario, str(r), str(world),
         str(store), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
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
def ranks4(tmp_path_factory):
    return run_ranks("sweep,layer,decisions,store", 4,
                     tmp_path_factory.mktemp("ranks4"))


@pytest.fixture(scope="module")
def bare_ranks(tmp_path_factory):
    return {n: run_ranks("bare", n, tmp_path_factory.mktemp(f"bare{n}"))
            for n in (1, 2)}


@pytest.mark.parametrize("world", [1, 2])
def test_bare_device_dist_spmv_matches_reference(bare_ranks, world):
    """``build_dist_spmv`` on a bare ``EHYBDevice`` (the reference's
    ``ehyb_from_device`` path: no fill plan, the live ER set from the
    nonzero mask) on 1 and 2 gloo ranks against the reference's
    ``build_dist_spmv(dev, mesh)`` on the same build, fp32, at
    ``tests/test_dist.py``'s tolerance; the pseudo build's refill is
    refused, as the reference's is."""
    import jax.numpy as jnp

    from repro.compat import make_mesh
    from repro.core import EHYBDevice as JEHYBDevice
    from repro.core.dist_spmv import build_dist_spmv as jbuild_dist_spmv

    m = poisson3d(12)
    e = jbuild_ehyb(m, n_parts=8, vec_size=-(-m.n // 8 // 8) * 8)
    x = np.random.default_rng(0).standard_normal(m.n).astype(np.float32)
    with pytest.warns(DeprecationWarning):
        mv = jbuild_dist_spmv(JEHYBDevice.from_ehyb(e),
                              make_mesh((1,), ("data",)), "data")
    want = np.asarray(mv(jnp.asarray(x)))
    got = bare_ranks[world]
    assert not got["jax_loaded"] and got["world"] == world
    assert got["bare/warned"] and got["bare/refill_refused"]
    assert got["bare/dtype"] == "torch.float32"
    assert got["bare/nnz"] == [e.nnz, e.nnz_in]
    np.testing.assert_allclose(np.asarray(got["bare/y"]), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(want, m.spmv(x.astype(np.float64)),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    return run_ranks("sweep", 8, tmp_path_factory.mktemp("ranks8"))


def _check_sweep(res: dict) -> None:
    assert not res["jax_loaded"]
    for k, v in res.items():
        if k.endswith(("err", "orig", "batched", "permuted")):
            assert v < 2e-4, (k, res)
    for name in ("poisson", "powerlaw"):
        assert res[name + "/context"] == "dist"
        assert res[name + "/replicated"], name
        assert res[name + "/orig_csr"] < 1e-5, name
        r0, r1 = res[name + "/solve_res"]
        assert abs(r0 - r1) < 1e-4, res
        assert abs(res[name + "/solve_iters"][0]
                   - res[name + "/solve_iters"][1]) <= 1, res
        assert res[name + "/halo_words"] < 0.35 * \
            res[name + "/allgather_words"], res
        assert res[name + "/fused_refused"]
    assert res["poisson/solve_status"] == "converged"
    assert res["poisson/solve_true_res"] <= 1e-5
    r0, r1 = res["poisson/bicg_res"]
    assert abs(r0 - r1) < 1e-4
    assert res["fp64/dtype"] == "torch.float64"
    assert res["fp64/err"] < 1e-10


def test_dist_equivalence_sweep_4_ranks(ranks4):
    """A 4-rank gloo group: op @ x, op @ X (K = 3), the permuted space, the
    distributed CG and BiCGStab against the port's local solve, fp64 — the
    reference's bounds."""
    _check_sweep(ranks4)
    assert ranks4["poisson/shard_rows"] * 4 >= 12 ** 3


def test_dist_equivalence_sweep_8_ranks(ranks8):
    """The same sweep on 8 ranks; powerlaw pushes partial sums there."""
    _check_sweep(ranks8)
    assert ranks8["powerlaw/has_push"]


def test_sharded_dtype_promotion(ranks4):
    """An int rhs is promoted to the value dtype, as ``op @ x`` is."""
    for name in ("poisson", "powerlaw"):
        assert ranks4[name + "/int_dtype"] == "torch.float32"
        assert ranks4[name + "/int"] < 1e-6


def test_sharded_refill_counters(ranks4):
    """update_values on a sharded operator: zero partitioning, build, halo
    plan, grouping or packing; the structure tensors shared; the result a
    fresh sharded bind's."""
    for name in ("poisson", "powerlaw"):
        assert ranks4[name + "/refill_structural"] == 0
        assert ranks4[name + "/refill_shared"]
        assert ranks4[name + "/refill_err"] < 2e-4
        assert ranks4[name + "/refill_vs_fresh"] == 0.0


def test_dist_padding_and_allgather_baseline(ranks4, ranks8):
    """n_parts = 6 over 4 ranks pads to 8; the all-gather baseline computes
    the same product where its partitions divide the mesh."""
    assert ranks4["pad/parts"] == [8, 2] and ranks8["pad/parts"] == [8, 1]
    for res in (ranks4, ranks8):
        assert res["pad/err"] < 2e-4
        assert any(k.endswith("allgather_err") for k in res)


def test_dist_spmv_shim_deprecated(ranks4):
    assert ranks4["shim/warned"] and ranks4["shim/err"] < 2e-4


def test_pruned_linear_mesh(ranks4):
    """``pruned_linear(mesh=)``: the forward and the gradients w.r.t. the
    input and the values equal the local layer's."""
    assert ranks4["layer/sharded"]
    for k in ("fwd", "grad_x", "grad_values"):
        assert ranks4["layer/" + k] < 2e-4, k


@pytest.mark.parametrize("name", ["poisson3d_16", "elasticity_8",
                                  "powerlaw_4k"])
def test_mesh_plan_decisions_equal_reference(ranks4, name):
    """``plan(A, mesh=)`` on 4 ranks decides format and partition as the
    reference's ``plan(A, mesh=)`` on a 4-device mesh (its memos emptied
    first: its format decisions are cached by pattern without the
    partition, so a decision another test took must not answer here)."""
    from repro.api import PLAN_CACHE as JPLAN_CACHE

    JPLAN_CACHE.clear()
    jat.clear_cache()
    p = jplan(JSUITE[name](), mesh=StubMesh(4))
    assert ranks4[f"{name}/context"] == p.context == "dist"
    assert ranks4[f"{name}/format"] == p.format
    assert ranks4[f"{name}/strategy"] == p.partition_strategy
    assert ranks4[f"{name}/modeled"] == dict(p.tuning.modeled_bytes)
    assert ranks4[f"{name}/part_modeled"] == \
        dict(p.partition_tuning.modeled_bytes)


def test_tune_store_keys_a_mesh_plan_by_its_size(ranks4):
    """A 4-rank plan's decisions are stored under a key ending in ``-d4``
    and served to a fresh cache: one store hit, no partitioning, the same
    decisions."""
    assert any("-d4-" in k for k in ranks4["store/keys"]), ranks4
    assert ranks4["store/hit"] == 1 and ranks4["store/partition"] == 0
    assert ranks4["store/same"] and ranks4["store/n_dev"] == 4


@pytest.mark.parametrize("n_dev", [1, 4])
def test_replayed_bf16_shards(n_dev, rng):
    """bf16 tables: the exchange carries fp32 words (the pushed partial
    sums accumulate in fp32) and the product stays within the reference's
    bf16 SpMV tolerance of the CSR product."""
    m = port(_matrix("powerlaw"))
    e = build_ehyb(m)
    _, sh = _shards(e, n_dev, torch.bfloat16)
    x = rng.standard_normal(m.n)
    xs = [shard_of(o, torch.as_tensor(x, dtype=torch.bfloat16))
          for o in sh]
    y = torch.cat(replay_apply(sh, xs))
    assert y.dtype == torch.bfloat16
    y_ref = m.spmv(x)
    y = y[sh[0].inv_perm[: m.n]].double().numpy()
    assert np.abs(y - y_ref).max() <= 1e-1 * max(np.abs(y_ref).max(), 1.0)


def test_serve_sparse_head_mesh(tmp_path):
    """ServeEngine accepts a mesh for the pruned decode head: a one-rank
    gloo group in this process (the reference's degenerate 1-device mesh),
    the same greedy tokens as the unsharded head and as the JAX engine,
    and the head's operator is a sharded plan whose container is the
    rank's ``EHYBShards``."""
    import jax
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro.configs import get_config as jget_config
    from repro.models import init_model as jinit_model
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch import convert
    from repro_torch.dist import EHYBShards
    from repro_torch.serve import Request, ServeEngine

    jcfg = jget_config("llama3_2_1b", smoke=True)
    jp = jinit_model(jax.random.PRNGKey(0), jcfg)
    cfg = convert.model_config(jcfg)
    params = convert.lm_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    prompt = np.arange(1, 7, dtype=np.int32)
    jeng = JServeEngine(jp, jcfg, batch=1, max_len=32, max_prompt=8,
                        sparse_head_density=0.9)
    jeng.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=4))
    want = jeng.run_until_done()[0].generated

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        outs = []
        for kw in ({}, {"sparse_head_mesh": mesh}):
            eng = ServeEngine(params, cfg, batch=1, max_len=32,
                              max_prompt=8, sparse_head_density=0.9,
                              device="cpu", **kw)
            eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
            outs.append(eng.run_until_done()[0].generated)
        op = eng.sparse_head.op
        assert op.plan.is_sharded and op.plan.mesh is mesh
        assert isinstance(op.obj, EHYBShards)
    finally:
        dist.destroy_process_group()
    assert outs[0] == outs[1] == want

"""The port's autotuner and byte model against the JAX package's.

Mirrors ``tests/test_autotune.py``, the ``TunedParams``/``sweep_grid``
part of ``tests/test_tuning.py`` and
``tests/test_reliability.py::test_tuner_skips_failing_measured_candidate``.
Matrices come from the reference's generators (seeded), handed to the port
as numpy arrays.  On the CPU the port plans at the reference's partition
geometry, so the default ``api.plan(m, device="cpu")`` must take the
reference's decisions exactly: the format, the partition strategy and
every modeled byte count of both tuning tables.
"""

import warnings

import numpy as np
import pytest
import torch

import repro.api as japi
from repro import autotune as jat
from repro.core import build_ehyb as jax_build_ehyb
from repro.core.matrices import SUITE, poisson3d, powerlaw, unstructured
from repro.core.sparse_linear import prune_to_csr as jax_prune_to_csr
from repro.core.partition import make_partition as jax_make_partition
from repro_torch import api as tapi
from repro_torch import autotune as tat
from repro_torch import tuning
from repro_torch.autotune import tuner
from repro_torch.core import counters
from repro_torch.core.ehyb import build_ehyb
from repro_torch.core.matrices import SparseCSR
from repro_torch.core.partition import (choose_vec_size_cuda,
                                        make_partition)
from repro_torch.reliability import ReliabilityWarning, chaos
from repro_torch.tuning import DEFAULT_PARAMS, SEARCH_SPACE, TunedParams

FORMATS = ["csr", "ell", "hyb", "dense", "ehyb", "ehyb_bucketed",
           "ehyb_packed"]
# the H100's constants (132 SMs, 227 KB of opt-in shared memory a block)
H100 = {"smem_per_block": 232448, "sm_count": 132}


def port(m) -> SparseCSR:
    """The reference's matrix as the port's (the same numpy arrays)."""
    return SparseCSR(m.n, m.indptr, m.indices, m.data)


@pytest.fixture(scope="module", autouse=True)
def _fresh_caches():
    """Both packages' plan and tune memos start empty: the reference's
    format decisions are cached by pattern without the partition, so a
    decision another module's test took must not answer here."""
    for c in (japi.PLAN_CACHE, tapi.PLAN_CACHE):
        c.clear()
    jat.clear_cache()
    tat.clear_cache()
    yield
    tapi.PLAN_CACHE.clear()
    tat.clear_cache()


# ---------------------------------------------------------------------------
# the default plan: the reference's decisions on every SUITE matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("workload", ["auto", "solver"])
@pytest.mark.parametrize("name", list(SUITE))
def test_default_plan_matches_reference(name, workload, k):
    m = SUITE[name]()
    jp = japi.plan(m, execution=japi.ExecutionConfig(workload=workload, k=k))
    tp = tapi.plan(port(m), execution=tapi.ExecutionConfig(
        workload=workload, k=k), device="cpu")
    assert tp.format == jp.format
    assert tp.partition_strategy == jp.partition_strategy
    assert tp.context == jp.context
    assert tp.tuning.modeled_bytes == jp.tuning.modeled_bytes
    assert tp.partition_tuning.modeled_bytes == \
        jp.partition_tuning.modeled_bytes
    assert tp.partition_tuning.in_part_fraction == \
        jp.partition_tuning.in_part_fraction
    assert tp.tuned == DEFAULT_PARAMS
    # a CPU plan never selects a format that launches CUDA kernels
    assert tat.get_format(tp.format).kernel == "plain"


def test_default_plan_binds_applies_and_solves():
    """``api.plan(A)``, its bind, ``op @ x`` and ``op.solve`` with every
    default, in the permuted space for an EHYB-family winner and the
    original one otherwise."""
    for name in ("elasticity_8", "circuit_4k"):
        m = port(SUITE[name]())
        op = tapi.plan(m, device="cpu").bind(m)
        assert op.tuning is op.plan.tuning
        x = np.random.default_rng(0).standard_normal(m.n)
        y = (op @ x).double().numpy()
        ref = m.spmv(x)
        assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-4
        b = m.spmv(np.ones(m.n))
        r = op.solve(b, precond="jacobi", tol=1e-6, max_iters=2000)
        assert r.status == "converged", name
        res = m.spmv(r.x.double().numpy()) - b
        assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-5
        assert op.plan.degraded == {}


def test_pinned_plan_shares_the_autotuned_partition():
    """The strategies' partitions come from the plan cache, so a plan
    pinned to a strategy the autotuned one priced partitions nothing."""
    m = port(SUITE["unstruct_4k"]())
    cache = tapi.PlanCache()
    p = tapi.plan(m, device="cpu", cache=cache)
    before = counters.snapshot()
    pinned = tapi.plan(m, execution=tapi.ExecutionConfig(
        format="ehyb", partition_method="bfs"), device="cpu", cache=cache)
    after = counters.snapshot()
    assert after.get("partition", 0) == before.get("partition", 0)
    assert pinned.partition is p.partition_tuning.partition or \
        pinned.partition.method == "bfs"
    stats = cache.stats()
    assert stats["plans"] == 2 and stats["partitions"] == 4
    assert stats["tune"]["disk"] is None


def test_format_without_partition_builds_no_host_ehyb():
    m = port(powerlaw(512, 6))
    counters.reset()
    op = tapi.plan(m, execution=tapi.ExecutionConfig(format="csr"),
                   device="cpu", cache=tapi.PlanCache()).bind(m)
    op2 = op.update_values(m.data * 2.0)
    assert op.plan.partition is None and op.plan.partition_tuning is None
    snap = counters.snapshot()
    assert snap.get("build_ehyb", 0) == 0 and snap.get("partition", 0) == 0
    y = (op2 @ np.ones(m.n)).double().numpy()
    ref = 2.0 * m.spmv(np.ones(m.n))
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-4


# ---------------------------------------------------------------------------
# the byte model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("context", ["spmv", "solver"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_estimate_bytes_and_terms_match_reference(fmt, context, k):
    for m in (poisson3d(8), powerlaw(512, 6), unstructured(1024, 10)):
        js = {"ehyb": jax_build_ehyb(m, method="bfs")}
        ts = {"ehyb": build_ehyb(port(m), method="bfs")}
        assert tat.estimate_bytes(port(m), fmt, 4, ts, context=context,
                                  k=k) == \
            jat.estimate_bytes(m, fmt, 4, js, context=context, k=k)
        terms = tat.estimate_terms(port(m), fmt, 2, ts, context=context,
                                   k=k)
        assert terms == jat.estimate_terms(m, fmt, 2, js, context=context,
                                           k=k)
        assert set(terms) == set(tat.TERMS)
        assert sum(terms.values()) == tat.estimate_bytes(
            port(m), fmt, 2, ts, context=context, k=k)


def test_cost_model_is_the_formats_own_accounting():
    """The family's models are the build's ``bytes_moved`` (§3.4); the
    solver context drops exactly the per-iteration perm round trip."""
    m = port(poisson3d(8))
    e = build_ehyb(m)
    shared = {"ehyb": e}
    assert tat.estimate_bytes(m, "ehyb", 4, shared) == e.bytes_moved(
        4, layout="tile", space="original", fused_er=True)["total"]
    assert tat.estimate_bytes(m, "ehyb_packed", 4, shared) == e.bytes_moved(
        4, layout="packed", space="original", fused_er=True)["total"]
    assert (tat.estimate_bytes(m, "ehyb", 4, shared)
            - tat.estimate_bytes(m, "ehyb", 4, shared, context="solver")
            == 2 * e.n_pad * 4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tat.estimate_bytes(m, "ehyb", 4, shared, context="dist")
    with pytest.raises(ValueError, match="unknown context"):
        tat.estimate_bytes(m, "ehyb", 4, shared, context="nope")


@pytest.mark.parametrize("context", ["spmv", "solver"])
def test_partition_cost_matches_reference_and_the_build(context):
    """``partition_cost`` equals the reference's for every strategy, and the
    tile accounting of the EHYB built on the partition — at the reference's
    geometry and at the H100's."""
    for m in (unstructured(1024, 10), powerlaw(512, 6)):
        tm = port(m)
        for method in ("natural", "bfs", "mincut", "hub"):
            jpart = jax_make_partition(m, method=method)
            tpart = make_partition(tm, method=method)
            assert tat.partition_cost(tm, tpart, 4, context=context) == \
                jat.partition_cost(m, jpart, 4, context=context)
            p, v = choose_vec_size_cuda(tm.n, 4, H100["smem_per_block"],
                                        H100["sm_count"])
            part = make_partition(tm, method=method, n_parts=p, vec_size=v)
            space = "original" if context == "spmv" else "permuted"
            want = build_ehyb(tm, part=part).bytes_moved(
                4, layout="tile", space=space, fused_er=True)
            got = tat.partition_cost(tm, part, 4, context=context)
            assert got["total"] == want["total"], (method, got, want)


@pytest.mark.parametrize("name", ["unstruct_8k", "elasticity_10"])
def test_mincut_at_card_geometry_matches_reference(name):
    """At the card's geometry mincut bisects ~130 times; each bisection
    reads only its vertex set's own entries, and the partition stays the
    reference's bit for bit."""
    m = SUITE[name]()
    p, v = choose_vec_size_cuda(m.n, 4, H100["smem_per_block"],
                                H100["sm_count"])
    tp = make_partition(port(m), method="mincut", n_parts=p, vec_size=v)
    jp = jax_make_partition(m, method="mincut", n_parts=p, vec_size=v)
    np.testing.assert_array_equal(tp.part_vec, jp.part_vec)
    np.testing.assert_array_equal(tp.perm, jp.perm)


def test_autotune_partition_prices_at_the_given_geometry():
    m = port(unstructured(1024, 10))
    cache = tapi.PlanCache()
    p, v = choose_vec_size_cuda(m.n, 4, H100["smem_per_block"],
                                H100["sm_count"])
    r = tat.autotune_partition(m, geometry=(p, v), cache=cache)
    assert (r.partition.n_parts, r.partition.vec_size) == (p, v)
    assert set(r.seconds) == set(r.modeled_bytes)
    r_cpu = tat.autotune_partition(m, cache=cache)
    assert r_cpu is not r and r_cpu.partition.n_parts != p
    assert tat.autotune_partition(m, geometry=(p, v), cache=cache) is r


def test_rank_formats_sorted_by_modeled_bytes():
    m = port(poisson3d(8))
    ranked = tat.rank_formats(m)
    table = tat.model_table(m)
    assert [f for f, _ in ranked] == \
        sorted(table, key=lambda f: (table[f], f))


def test_ranking_reflects_matrix_structure():
    """Structured stencil: EHYB-family beats CSR (the paper's claim).
    Powerlaw: ELL/EHYB padding explodes and CSR must win instead."""
    t_stencil = tat.model_table(port(poisson3d(16)))
    assert t_stencil["ehyb"] < t_stencil["csr"]
    pw = port(powerlaw(2048, 6))
    t_power = tat.model_table(pw)
    assert t_power["csr"] < t_power["ell"]
    assert t_power["csr"] < t_power["ehyb"]
    assert tat.autotune(pw, device="cpu").format == "csr"


def test_autotune_cached_selection_is_deterministic():
    m = port(poisson3d(6))
    tat.clear_cache()
    r1 = tat.autotune(m, device="cpu")
    assert tat.autotune(m, device="cpu") is r1
    assert tat.tune_cache_info()["entries"] == 1
    tat.clear_cache()
    r3 = tat.autotune(m, device="cpu")
    assert (r3.format, r3.key, r3.modeled_bytes) == \
        (r1.format, r1.key, r1.modeled_bytes)


def test_registry_rejects_unknown_and_duplicate():
    with pytest.raises(KeyError):
        tat.get_format("no_such_format")
    with pytest.raises(ValueError):
        tat.register_format(tat.get_format("csr"))
    assert tat.available_formats() == sorted(jat.available_formats())


# ---------------------------------------------------------------------------
# eligibility on the CPU, the measured pass, chaos
# ---------------------------------------------------------------------------

def test_cuda_formats_never_selected_on_a_cpu_plan():
    for mgen in (poisson3d(8), poisson3d(16)):
        m = port(mgen)
        r = tat.autotune(m, device="cpu")
        assert r.format != "ehyb_packed" and "ehyb_packed" in r.modeled_bytes
        assert tapi.plan(m, execution=tapi.ExecutionConfig(k=16),
                         device="cpu").format != "ehyb_packed"
        r = tat.autotune(m, device="cpu", mode="measure", top_k=7,
                         use_cache=False)
        assert "ehyb_packed" not in r.measured_s


def test_measured_mode_times_top_candidates():
    m = port(poisson3d(6))
    before = counters.snapshot().get("tune.measured", 0)
    r = tat.autotune(m, mode="measure", use_cache=False, top_k=2,
                     device="cpu")
    assert r.measured_s and len(r.measured_s) <= 2
    assert r.format == min(sorted(r.measured_s), key=r.measured_s.get)
    assert counters.snapshot()["tune.measured"] == before + len(r.measured_s)
    p = tapi.plan(m, execution=tapi.ExecutionConfig(mode="measure",
                                                    workload="solver"),
                  device="cpu")
    assert p.tuning.mode == "measure" and p.format in p.tuning.measured_s


def test_time_spmv_bumps_measured_counter():
    before = counters.snapshot().get("tune.measured", 0)
    tuner._time_spmv(lambda o, x: x * 2.0, None, torch.ones(8), repeats=1,
                     min_duration_s=0.0)
    assert counters.snapshot()["tune.measured"] == before + 1


def test_measured_sweep_picks_bucketed_knob():
    m = port(powerlaw(2048, 6))
    r = tat.autotune(m, mode="measure", candidates=("ehyb_bucketed",),
                     use_cache=False, device="cpu")
    assert r.format == "ehyb_bucketed"
    assert len(r.sweep_s) == len(SEARCH_SPACE["n_buckets"].candidates)
    assert r.tuned["n_buckets"] in SEARCH_SPACE["n_buckets"].candidates
    p = tapi.plan(m, execution=tapi.ExecutionConfig(
        mode="measure", candidates=("ehyb_bucketed",)), device="cpu")
    op = p.bind(m)
    assert p.tuned == TunedParams.from_dict(p.tuning.tuned)
    assert len(op.obj.widths) <= p.tuned.n_buckets
    np.testing.assert_allclose((op @ np.ones(m.n)).double().numpy(),
                               m.spmv(np.ones(m.n)), rtol=1e-4, atol=1e-4)


def test_tuner_skips_failing_measured_candidate():
    m = port(unstructured(192, 7, seed=35))
    before = counters.snapshot()
    kw = dict(mode="measure", candidates=("csr", "ell", "hyb"),
              device="cpu")
    with chaos(kernel_failure=("tune:ell",)) as cfg:
        with pytest.warns(ReliabilityWarning, match="'ell' failed"):
            t = tat.autotune(m, **kw)
    assert cfg.injected["kernel:tune:ell"] == 1
    assert "ell" not in (t.measured_s or {})
    assert t.format in ("csr", "hyb")
    after = counters.snapshot()
    assert after.get("tune.candidate_failed", 0) == \
        before.get("tune.candidate_failed", 0) + 1
    # the ranking decided under chaos was not cached
    with warnings.catch_warnings():
        warnings.simplefilter("error", ReliabilityWarning)
        t2 = tat.autotune(m, **kw)
    assert "ell" in t2.measured_s


def test_cpu_plan_skips_an_organic_candidate_failure(monkeypatch):
    """On a CPU plan any failure of a measured candidate skips it, as in
    the reference; the card's rule (only an injected fault skips) is in
    ``tests/test_torch_cuda.py``."""
    import dataclasses

    from repro_torch.autotune import registry

    def broken(*a, **kw):
        raise MemoryError("organic")
    monkeypatch.setitem(registry.FORMATS, "ell", dataclasses.replace(
        registry.get_format("ell"), build=broken))
    m = port(unstructured(192, 7, seed=35))
    with pytest.warns(ReliabilityWarning, match="MemoryError"):
        t = tat.autotune(m, mode="measure", use_cache=False,
                         candidates=("csr", "ell", "hyb"), device="cpu")
    assert "ell" not in t.measured_s


# ---------------------------------------------------------------------------
# tunable parameters
# ---------------------------------------------------------------------------

class TestTunedParams:
    def test_token_is_sorted_and_hashable(self):
        t = TunedParams(rhs_chunk=8)
        assert t.token() == (("n_buckets", 4), ("rhs_chunk", 8))
        assert hash(t.token())

    def test_from_dict_ignores_unknown_and_defaults_missing(self):
        t = TunedParams.from_dict({"gather_budget": 2 << 20,
                                   "not_a_knob": 99, "n_buckets": 2})
        assert t.n_buckets == 2
        assert t.rhs_chunk == DEFAULT_PARAMS.rhs_chunk

    @pytest.mark.parametrize("bad", [{"rhs_chunk": 100000},
                                     {"rhs_chunk": 64},
                                     {"n_buckets": 0}])
    def test_out_of_bounds_raises(self, bad):
        with pytest.raises(ValueError, match="declared bounds"):
            TunedParams.from_dict(bad)

    def test_candidates_inside_bounds(self):
        for spec in SEARCH_SPACE.values():
            for c in spec.candidates:
                assert spec.lo <= c <= spec.hi
            assert spec.lo <= spec.default <= spec.hi

    def test_sweep_grid_per_format(self):
        assert list(tuning.sweep_grid("ehyb_packed")) == [DEFAULT_PARAMS]
        spmm = list(tuning.sweep_grid("ehyb_packed", k=8))
        assert [t.rhs_chunk for t in spmm] == \
            list(SEARCH_SPACE["rhs_chunk"].candidates)
        assert [t.n_buckets for t in tuning.sweep_grid("ehyb_bucketed")] \
            == list(SEARCH_SPACE["n_buckets"].candidates)
        assert list(tuning.sweep_grid("csr", k=8)) == [DEFAULT_PARAMS]

    def test_execution_token_includes_tuned(self):
        a = tapi.ExecutionConfig(format="ehyb_packed")
        b = tapi.ExecutionConfig(format="ehyb_packed",
                                 tuned={"rhs_chunk": 8})
        assert isinstance(b.tuned, TunedParams)
        assert a.token() != b.token()
        assert b.token()[-1] == b.tuned.token()
        with pytest.raises(ValueError, match="declared bounds"):
            tapi.ExecutionConfig(tuned={"rhs_chunk": 0})
        with pytest.raises(TypeError):
            tapi.ExecutionConfig(tuned=8)

    def test_tuned_rhs_chunk_reaches_the_packed_spmm(self, monkeypatch):
        """The plan's tuned ``rhs_chunk`` rides the packed container into
        the SpMM wrapper (the reference's ``kparams``); the product is the
        same at every chunk width."""
        from repro_torch.kernels import ehyb_spmm as KM

        seen = []
        real = KM.ehyb_packed_fused_spmm

        def spy(*a, rhs_chunk=None, **kw):
            seen.append(rhs_chunk)
            return real(*a, rhs_chunk=rhs_chunk, **kw)
        monkeypatch.setattr(KM, "ehyb_packed_fused_spmm", spy)
        m = port(unstructured(1024, 10))
        X = np.random.default_rng(1).standard_normal((m.n, 5))
        ys = []
        for rc in (8, 32):
            p = tapi.plan(m, execution=tapi.ExecutionConfig(
                format="ehyb_packed", partition_method="bfs",
                tuned={"rhs_chunk": rc}), device="cpu")
            op = p.bind(m)
            assert p.tuned.rhs_chunk == op.obj.rhs_chunk == rc
            ys.append((op @ X).double().numpy())
            assert seen[-1] == rc
            assert op.update_values(m.data * 2.0).obj.rhs_chunk == rc
        np.testing.assert_array_equal(ys[0], ys[1])
        np.testing.assert_allclose(ys[0], m.to_dense() @ X, rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the pruned layer with its defaults
# ---------------------------------------------------------------------------

def test_pruned_linear_defaults_rank_at_the_token_width():
    w = np.random.default_rng(5).standard_normal((96, 160))
    x = np.random.default_rng(6).standard_normal((16, 160))
    for k in (1, 16):
        layer = tapi.pruned_linear(w, 0.1, k=k, device="cpu")
        jp = japi.plan(jax_prune_to_csr(w, 0.1),
                       execution=japi.ExecutionConfig(k=k))
        assert layer.op.format == jp.format
        assert layer.op.tuning.modeled_bytes == jp.tuning.modeled_bytes
        assert layer.op.plan.partition_strategy == jp.partition_strategy
        dense = jax_prune_to_csr(w, 0.1).to_dense()[:96, :160]
        y = layer(x).detach().double().numpy()
        assert np.abs(y - x @ dense.T).max() / np.abs(x @ dense.T).max() \
            < 1e-4
        b = layer.bytes_vs_dense()
        assert b["format"] == layer.op.format and b["sparse"] > 0

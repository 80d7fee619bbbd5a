"""The port's persistent tune store and calibrated cost model against the
JAX package's.

Mirrors ``tests/test_tuning.py`` (``TestCalibration``, ``TestStore``,
``TestChaosHygiene``, ``TestWarmStart`` and the fresh-process warm start):
``fit``, ``evaluate`` and ``fingerprint`` on the same synthetic samples
give the reference's numbers, the same model installed in both packages
gives the same calibrated seconds and winners on every SUITE matrix, and a
plan served from the store equals the cold plan that saved it with zero
partitioning passes and zero tuner measurements (counters, not timings),
also in a fresh process that imports no jax.  Calibration tests use
synthetic samples and assert nothing about a ranking by measured CPU time,
which flips from run to run.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
from repro import autotune as jat
from repro import tuning as jtuning
from repro.core.matrices import SUITE, poisson3d
from repro.tuning.calibration import CalibrationModel as JModel
from repro.tuning.calibration import evaluate as jevaluate
from repro.tuning.calibration import fit as jfit
from repro_torch import api as tapi
from repro_torch import autotune as tat
from repro_torch import tuning
from repro_torch.core import counters
from repro_torch.core.matrices import SparseCSR
from repro_torch.core.partition import make_partition
from repro_torch.reliability import chaos
from repro_torch.tuning import DEFAULT_PARAMS, TunedParams, TuneStore
from repro_torch.tuning.calibration import CalibrationModel, evaluate, fit
from repro_torch.tuning.store import TuneEntry, entry_key

SRC = Path(__file__).resolve().parents[1] / "src"
FORMATS = ["csr", "dense", "ehyb", "ehyb_bucketed", "ehyb_packed", "ell",
           "hyb"]


def port(m) -> SparseCSR:
    return SparseCSR(m.n, m.indptr, m.indices, m.data)


@pytest.fixture(autouse=True)
def _isolated_caches():
    """Every test starts with no store, no calibration and empty plan and
    tune memos in both packages, and leaks none of them."""
    for t in (tuning, jtuning):
        t.set_store(None)
        t.set_model(None)
    for c in (tapi.PLAN_CACHE, japi.PLAN_CACHE):
        c.clear()
    tat.clear_cache()
    jat.clear_cache()
    yield
    for t in (tuning, jtuning):
        t.clear_store()
        t.clear_model()
    for c in (tapi.PLAN_CACHE, japi.PLAN_CACHE):
        c.clear()
    tat.clear_cache()
    jat.clear_cache()


def _store(tmp_path) -> TuneStore:
    return tuning.set_store(tmp_path / "tunecache")


# ---------------------------------------------------------------------------
# calibration: fit/predict/evaluate against the reference (no timing)
# ---------------------------------------------------------------------------

def _floor_samples():
    """The reference's ``TestCalibration._samples``: 1 GB/s on every term
    plus a dispatch floor for format "b" that raw bytes cannot see."""
    coef = 1e-9
    floors = {"a": 0.0, "b": 5e-3}
    samples = []
    for i, scale in enumerate((1, 2, 4)):
        for f in ("a", "b"):
            ell = int(1e6 * scale * (0.9 if f == "b" else 1.0))
            terms = {"ell": ell, "er": int(1e5 * scale)}
            t = floors[f] + coef * sum(terms.values())
            samples.append({"matrix": f"m{i}", "format": f, "terms": terms,
                            "modeled_bytes": sum(terms.values()),
                            "measured_s": t, "hlo_bytes": None})
    return samples


def _random_samples(seed: int):
    """Every term of ``cost.TERMS`` and all seven formats, with noise: a
    dense design the clamps and the intercept re-derivation both act on."""
    rng = np.random.default_rng(seed)
    coef = {t: c for t, c in zip(tat.TERMS, rng.uniform(0.2, 3.0, 6) * 1e-9)}
    samples = []
    for i in range(6):
        for f in FORMATS:
            terms = {t: int(rng.integers(0, 5e6)) for t in tat.TERMS}
            t = rng.uniform(0, 2e-4) + sum(coef[k] * v
                                           for k, v in terms.items())
            samples.append({"matrix": f"m{i}", "format": f, "terms": terms,
                            "modeled_bytes": sum(terms.values()),
                            "measured_s": t * rng.uniform(0.8, 1.25),
                            "hlo_bytes": None})
    return samples


SAMPLE_SETS = {"floor": _floor_samples, "random0": lambda: _random_samples(0),
               "random1": lambda: _random_samples(1)}


def _rel_equal(a: dict, b: dict, rel=1e-12):
    assert set(a) == set(b)
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=rel, abs=1e-300), k


@pytest.mark.parametrize("which", list(SAMPLE_SETS))
def test_fit_evaluate_fingerprint_match_reference(which):
    samples = SAMPLE_SETS[which]()
    tm = fit(samples, backend="test")
    jm = jfit(samples, backend="test")
    _rel_equal(tm.coef, jm.coef)
    _rel_equal(tm.intercept, jm.intercept)
    _rel_equal(tm.stats, jm.stats)
    assert tm.n_samples == jm.n_samples
    assert json.dumps(tm.to_dict(), sort_keys=True) == \
        json.dumps(jm.to_dict(), sort_keys=True)
    assert tm.fingerprint() == jm.fingerprint()
    te, je = evaluate(samples, tm), jevaluate(samples, jm)
    for k in ("contested", "agree_raw", "agree_calibrated"):
        assert te[k] == je[k]
    for k in ("ratio_geomean", "ratio_min", "ratio_max"):
        assert te[k] == pytest.approx(je[k], rel=1e-12)
    for tr, jr in zip(te["matrices"], je["matrices"]):
        assert {k: tr[k] for k in ("matrix", "measured_winner", "raw_winner",
                                   "calibrated_winner")} == \
            {k: jr[k] for k in ("matrix", "measured_winner", "raw_winner",
                                "calibrated_winner")}
        _rel_equal(tr["predicted_s"], jr["predicted_s"])
    # the payload round-trips through the other package
    assert CalibrationModel.from_dict(jm.to_dict()).fingerprint() == \
        jm.fingerprint()
    assert JModel.from_dict(tm.to_dict()).fingerprint() == tm.fingerprint()


def test_fit_recovers_bandwidth_and_floor():
    samples = _floor_samples()
    model = fit(samples, backend="test")
    assert model.coef["ell"] == pytest.approx(1e-9, rel=0.2)
    assert model.intercept["b"] - model.intercept["a"] == \
        pytest.approx(5e-3, rel=0.2)
    assert all(v >= 0 for v in model.coef.values())
    assert all(v >= 0 for v in model.intercept.values())
    ev = evaluate(samples, model)
    assert ev["agree_calibrated"] == ev["contested"]
    assert ev["agree_raw"] == 0
    assert 0.5 < ev["ratio_geomean"] < 2.0


def test_fingerprint_tracks_payload():
    m1 = fit(_floor_samples(), backend="test")
    m2 = CalibrationModel.from_dict(m1.to_dict())
    assert m1.fingerprint() == m2.fingerprint()
    m3 = CalibrationModel(backend="test", coef={**m1.coef, "ell": 1.0},
                          intercept=m1.intercept)
    assert m3.fingerprint() != m1.fingerprint()
    with pytest.raises(ValueError, match="version"):
        CalibrationModel.from_dict({**m1.to_dict(), "version": 99})


def test_fit_refuses_zero_samples():
    with pytest.raises(ValueError, match="zero samples"):
        fit([], backend="test")


def _skewed_model(cls):
    """A model whose per-term rates and per-format floors differ enough to
    move winners away from the raw-bytes argmin on some matrices."""
    coef = {"ell": 1.0e-9, "x_cache": 0.2e-9, "er": 4.0e-9, "y": 1.0e-9,
            "perm": 3.0e-9, "interconnect": 0.0}
    intercept = {"csr": 2e-6, "dense": 0.0, "ehyb": 6e-6,
                 "ehyb_bucketed": 9e-6, "ehyb_packed": 1e-6, "ell": 3e-6,
                 "hyb": 4e-6}
    return cls(backend="cpu", coef=coef, intercept=intercept)


@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("name", list(SUITE))
def test_calibrated_ranking_matches_reference(name, k):
    """The same model installed in both packages: the same calibrated
    seconds per candidate and the same winner."""
    m = SUITE[name]()
    jtuning.set_model(_skewed_model(JModel))
    tuning.set_model(_skewed_model(CalibrationModel))
    jp = japi.plan(m, execution=japi.ExecutionConfig(k=k))
    tp = tapi.plan(port(m), execution=tapi.ExecutionConfig(k=k),
                   device="cpu")
    assert tp.tuning.calibrated_s is not None
    _rel_equal(tp.tuning.calibrated_s, jp.tuning.calibrated_s)
    assert tp.format == jp.format
    assert tp.partition_strategy == jp.partition_strategy


def test_model_reranks_autotune_and_keys_cache():
    m = port(poisson3d(8))
    r0 = tat.autotune(m, device="cpu")
    assert r0.calibrated_s is None
    # a model that makes "dense" free must flip the winner
    bad = CalibrationModel(
        backend="cpu", coef={**{t: 1e-6 for t in tat.TERMS}, "ell": 0.0,
                             "x_cache": 0.0, "y": 0.0},
        intercept={f: (0.0 if f == "dense" else 1.0)
                   for f in tat.available_formats()})
    tuning.set_model(bad)
    r1 = tat.autotune(m, device="cpu")
    assert r1.calibrated_s is not None and r1.format == "dense"
    # the fingerprint is in the cache key: without the model the
    # calibrated decision is not served
    tuning.set_model(None)
    assert tat.autotune(m, device="cpu").format == r0.format


@pytest.mark.parametrize("mode", ["model", "measure"])
def test_format_beyond_device_memory_is_not_a_candidate(monkeypatch, mode):
    """Under a calibration that makes "dense" free, a device too small for
    the dense table (as the card is for a large pattern) never ranks,
    measures or selects it; the modeled bytes still list it."""
    from repro_torch.autotune import tuner

    m = port(poisson3d(8))
    bad = CalibrationModel(
        backend="cpu", coef={**{t: 1e-6 for t in tat.TERMS}, "ell": 0.0,
                             "x_cache": 0.0, "y": 0.0},
        intercept={f: (0.0 if f == "dense" else 1.0)
                   for f in tat.available_formats()})
    tuning.set_model(bad)
    built = []
    monkeypatch.setitem(tat.FORMATS, "dense", dataclasses.replace(
        tat.get_format("dense"),
        build=lambda *a, **kw: built.append(a) or 1 / 0))
    dense_bytes = m.n * m.n * 4
    monkeypatch.setattr(tuner, "_device_capacity", lambda d: dense_bytes - 1)
    r = tat.autotune(m, device="cpu", mode=mode, use_cache=False)
    assert r.format != "dense" and "dense" not in r.calibrated_s
    assert r.modeled_bytes["dense"] > dense_bytes - 1
    assert r.format == min(sorted(r.measured_s or r.calibrated_s),
                           key=(r.measured_s or r.calibrated_s).get)
    assert not built
    # nothing fits: the tuner says so instead of building anyway
    monkeypatch.setattr(tuner, "_device_capacity", lambda d: 1)
    with pytest.raises(ValueError, match="fits"):
        tat.autotune(m, device="cpu", mode=mode, use_cache=False)


def test_stored_calibration_ranks_plans_of_its_backend(tmp_path):
    """A calibration persisted for the ``cpu`` backend is found by a CPU
    plan through the store (no explicit model), and ranks it."""
    st = _store(tmp_path)
    tuning.clear_model()
    model = _skewed_model(CalibrationModel)
    assert st.save_calibration(model.to_dict(), "cpu")
    assert tuning.get_model("cpu").fingerprint() == model.fingerprint()
    assert tuning.get_model("cuda-other-sm90") is None
    p = tapi.plan(port(poisson3d(8)), device="cpu")
    assert p.tuning.calibrated_s is not None


def test_measure_suite_terms_equal_reference_estimate_terms():
    names = ("poisson3d_16", "powerlaw_4k")
    samples = tuning.measure_suite(names, device="cpu")
    by = {(s["matrix"], s["format"]): s for s in samples}
    # formats whose applies launch CUDA kernels are not timed on the CPU
    assert {f for _, f in by} == set(FORMATS) - {"ehyb_packed"}
    for name in names:
        m = SUITE[name]()
        shared: dict = {}
        for f in FORMATS:
            if f == "ehyb_packed":
                continue
            s = by[(name, f)]
            want = jat.estimate_terms(m, f, 4, shared)
            assert s["terms"] == {t: int(v) for t, v in want.items()}
            assert s["modeled_bytes"] == sum(want.values())
            assert s["measured_s"] > 0
            # the cross-check column: one plain apply's op bytes, which
            # read every stored value at least once (fp32)
            assert s["hlo_bytes"] >= 4 * m.nnz, (name, f, s["hlo_bytes"])


def test_calibrate_persists_installs_and_reports(tmp_path):
    st = _store(tmp_path)
    out = tuning.calibrate(["poisson3d_16"], formats=("csr", "ell"),
                           device="cpu")
    assert out["persisted"] and out["model"]["backend"] == "cpu"
    assert out["model"]["n_samples"] == 2
    assert tuning.get_model().fingerprint() == \
        CalibrationModel.from_dict(out["model"]).fingerprint()
    assert st.load_calibration("cpu")["coef"] == out["model"]["coef"]
    text = tuning.report(device="cpu")
    assert "calibration [cpu]" in text and "GB/s" in text
    tuning.set_model(None)
    assert "no calibration model" in tuning.report(device="cpu")


def test_cli_report_stats_and_calibrate(tmp_path, capsys):
    from repro_torch.tuning.__main__ import main

    _store(tmp_path)
    assert main([]) == 2
    capsys.readouterr()                     # the help text
    assert main(["--calibrate", "--device", "cpu", "--suite",
                 "poisson3d_16", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["persisted"] and payload["model"]["backend"] == "cpu"
    assert main(["--report", "--device", "cpu"]) == 0
    assert "calibration [cpu]" in capsys.readouterr().out
    assert main(["--stats"]) == 0
    assert json.loads(capsys.readouterr().out)["saved"] == 1


# ---------------------------------------------------------------------------
# the persistent store
# ---------------------------------------------------------------------------

def _entry(**kw) -> TuneEntry:
    base = dict(pattern="deadbeef", backend="cpu", dtype="float32",
                context="spmv", k=1, n_dev=1, format="ehyb",
                partition_method="bfs", tuned=DEFAULT_PARAMS.to_dict())
    base.update(kw)
    return TuneEntry(**base)


def test_backend_key_names_the_card(monkeypatch):
    assert tuning.backend_key(torch.device("cpu")) == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (9, 0))
    assert tuning.backend_key(torch.device("cuda")) == \
        "cuda-NVIDIA_H100_80GB_HBM3-sm90"
    assert tuning.ENV_VAR == "REPRO_TORCH_TUNE_CACHE" != jtuning.ENV_VAR


class TestStore:
    def test_round_trip_entry_and_partition(self, tmp_path):
        st = _store(tmp_path)
        m = port(poisson3d(8))
        part = make_partition(m, method="bfs")
        key = tat.pattern_hash(m)
        assert st.save(_entry(pattern=key), part)
        entry, part2 = st.load(key, "cpu", "float32", "spmv")
        assert entry.format == "ehyb"
        assert entry.tuned_params() == DEFAULT_PARAMS
        np.testing.assert_array_equal(part2.perm, part.perm)
        np.testing.assert_array_equal(part2.part_vec, part.part_vec)
        np.testing.assert_array_equal(part2.inv_perm, part.inv_perm)
        assert (part2.n_parts, part2.vec_size) == (part.n_parts,
                                                   part.vec_size)
        assert st.counters["hit"] == 1

    def test_miss_counts(self, tmp_path):
        st = _store(tmp_path)
        assert st.load("nope", "cpu", "float32", "spmv") is None
        assert st.counters["miss"] == 1

    def test_mode_is_part_of_the_key(self, tmp_path):
        st = _store(tmp_path)
        st.save(_entry(mode="measure"))
        assert st.load("deadbeef", "cpu", "float32", "spmv") is None
        assert st.load("deadbeef", "cpu", "float32", "spmv",
                       mode="measure") is not None
        assert entry_key("p", "cpu", "float32", "spmv") == \
            "p-cpu-float32-spmv-k1-d1-model"

    def test_truncated_json_quarantined(self, tmp_path):
        st = _store(tmp_path)
        st.save(_entry())
        key = entry_key("deadbeef", "cpu", "float32", "spmv")
        jp = st._json_path(key)
        jp.write_text(jp.read_text()[:37])          # truncate mid-payload
        with pytest.warns(UserWarning, match="quarantined"):
            assert st.load("deadbeef", "cpu", "float32", "spmv") is None
        assert st.counters["quarantined"] == 1
        assert not jp.exists()
        assert jp.with_suffix(".json.bad").exists()   # kept for post-mortem

    def test_out_of_bounds_tuned_is_corruption(self, tmp_path):
        st = _store(tmp_path)
        # the reference's case is gather_budget=7; the port has no
        # gather_budget (unknown keys are ignored), so its own knob
        st.save(_entry(tuned={"rhs_chunk": 100000}))
        with pytest.warns(UserWarning, match="quarantined"):
            assert st.load("deadbeef", "cpu", "float32", "spmv") is None
        assert st.counters["quarantined"] == 1

    def test_corrupt_partition_npz_quarantined(self, tmp_path):
        st = _store(tmp_path)
        m = port(poisson3d(8))
        key = tat.pattern_hash(m)
        st.save(_entry(pattern=key), make_partition(m, method="bfs"))
        skey = entry_key(key, "cpu", "float32", "spmv")
        st._npz_path(skey).write_bytes(b"not an npz at all")
        with pytest.warns(UserWarning, match="quarantined"):
            assert st.load(key, "cpu", "float32", "spmv") is None
        assert st.counters["quarantined"] == 1

    def test_partition_of_another_geometry_quarantined(self, tmp_path):
        """A card partition is sized by the card: a stored partition of
        another (n_parts, vec_size) is inconsistent for the plan asking."""
        st = _store(tmp_path)
        m = port(poisson3d(8))
        key = tat.pattern_hash(m)
        part = make_partition(m, method="bfs", n_parts=4, vec_size=128)
        st.save(_entry(pattern=key), part)
        with pytest.warns(UserWarning, match="geometry"):
            assert st.load(key, "cpu", "float32", "spmv",
                           geometry=(2, 256)) is None
        assert st.counters["quarantined"] == 1
        assert st.entries() == []
        # the plan's own path: a stored partition of another geometry is
        # quarantined and the plan tunes cold, with its own geometry
        p0 = tapi.plan(m, device="cpu")
        entry, stored = st.load(key, "cpu", "float32", "spmv")
        st.save(entry, make_partition(m, method=p0.partition_strategy,
                                      n_parts=2 * p0.n_parts,
                                      vec_size=p0.vec_size // 2))
        tapi.PLAN_CACHE.clear()
        tat.clear_cache()
        with pytest.warns(UserWarning, match="geometry"):
            p1 = tapi.plan(m, device="cpu")
        assert p1.tuning is not None          # tuned cold, not served
        assert (p1.n_parts, p1.vec_size) == (p0.n_parts, p0.vec_size)

    def test_stale_version_evicted(self, tmp_path):
        st = _store(tmp_path)
        st.save(_entry())
        key = entry_key("deadbeef", "cpu", "float32", "spmv")
        jp = st._json_path(key)
        raw = json.loads(jp.read_text())
        raw["version"] = 999
        jp.write_text(json.dumps(raw))
        assert st.load("deadbeef", "cpu", "float32", "spmv") is None
        assert st.counters["stale"] == 1
        assert not jp.exists()                       # deleted, not .bad

    def test_evict_by_pattern_and_all(self, tmp_path):
        st = _store(tmp_path)
        st.save(_entry(pattern="aaa"))
        st.save(_entry(pattern="bbb"))
        assert st.evict("aaa") == 1
        assert st.entries() and st.evict() == 1
        assert st.entries() == []

    def test_env_var_activation(self, tmp_path, monkeypatch):
        tuning.clear_store()       # drop the fixture's explicit None
        monkeypatch.setenv(tuning.ENV_VAR, str(tmp_path / "envstore"))
        st = tuning.get_store()
        assert st is not None
        assert str(tmp_path) in str(st.root)
        assert tuning.get_store() is st              # memoized per path
        tuning.set_store(None)
        assert tuning.get_store() is None            # explicit None wins

    def test_corrupt_calibration_quarantined(self, tmp_path):
        st = _store(tmp_path)
        st._calib_path("cpu").write_text("{not json")
        with pytest.warns(UserWarning, match="quarantined"):
            assert st.load_calibration("cpu") is None
        tuning.clear_model()
        assert tuning.get_model("cpu") is None


# ---------------------------------------------------------------------------
# chaos hygiene: nothing decided under fault injection reaches disk
# ---------------------------------------------------------------------------

class TestChaosHygiene:
    def test_save_refused_under_chaos(self, tmp_path):
        st = _store(tmp_path)
        with chaos(kernel_failure=("tune:ell",)):
            assert not st.save(_entry())
        assert st.counters["refused_chaos"] == 1
        assert st.entries() == []

    def test_calibration_persist_refused_under_chaos(self, tmp_path):
        st = _store(tmp_path)
        with chaos(kernel_failure=("tune:ell",)):
            assert not st.save_calibration({"coef": {}}, "cpu")
        assert st.load_calibration("cpu") is None
        assert st.counters["refused_chaos"] == 1

    def test_store_stays_clean_through_chaotic_planning(self, tmp_path):
        st = _store(tmp_path)
        m = port(poisson3d(8))
        with chaos(kernel_failure=("tune:ehyb",)):
            with pytest.warns(Warning):
                tapi.plan(m, execution=tapi.ExecutionConfig(mode="measure"),
                          device="cpu")
        assert st.entries() == []
        assert st.counters["refused_chaos"] >= 1
        # once chaos exits, the same plan persists normally
        tapi.PLAN_CACHE.clear()
        tat.clear_cache()
        tapi.plan(m, device="cpu")
        assert len(st.entries()) == 1


# ---------------------------------------------------------------------------
# warm start: the whole point of the store
# ---------------------------------------------------------------------------

def _cold_then_warm(m, execution=None):
    cold = tapi.plan(m, execution=execution, device="cpu")
    tapi.PLAN_CACHE.clear()
    tat.clear_cache()
    before = counters.snapshot()
    warm = tapi.plan(m, execution=execution, device="cpu")
    after = counters.snapshot()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in set(after) | set(before)}
    return cold, warm, delta


class TestWarmStart:
    @pytest.mark.parametrize("mode", ["model", "measure"])
    def test_warm_plan_identity_matches_cold(self, tmp_path, mode):
        st = _store(tmp_path)
        m = port(SUITE["poisson3d_16"]())
        ex = tapi.ExecutionConfig(mode=mode)
        cold, warm, delta = _cold_then_warm(m, ex)
        assert st.counters["saved"] == 1 and st.counters["hit"] == 1
        assert warm.identity() == cold.identity()
        assert warm.tuning is None and warm.partition_tuning is None
        assert delta.get("partition", 0) == 0
        assert delta.get("tune.measured", 0) == 0
        assert delta.get("tune_store.hit", 0) == 1
        np.testing.assert_array_equal(warm.partition.perm,
                                      cold.partition.perm)
        # the bind builds the host tables on the stored partition
        before = counters.snapshot().get("partition", 0)
        x = np.random.default_rng(0).standard_normal(m.n)
        y = (warm.bind(m) @ x).double().numpy()
        assert counters.snapshot().get("partition", 0) == before
        np.testing.assert_allclose(y, m.spmv(x), rtol=1e-5, atol=1e-5)

    def test_measured_and_modeled_plans_are_two_entries(self, tmp_path):
        st = _store(tmp_path)
        m = port(poisson3d(8))
        tapi.plan(m, device="cpu")
        p = tapi.plan(m, execution=tapi.ExecutionConfig(mode="measure"),
                      device="cpu")
        assert p.tuning.measured_s            # measured, not served
        assert len(st.entries()) == 2

    def test_pinned_format_is_not_persisted_and_reads_the_store(
            self, tmp_path):
        st = _store(tmp_path)
        m = port(poisson3d(8))
        tapi.plan(m, execution=tapi.ExecutionConfig(format="csr"),
                  device="cpu")
        assert st.entries() == []             # a pin is not a decision
        auto = tapi.plan(m, device="cpu")
        assert len(st.entries()) == 1
        tapi.PLAN_CACHE.clear()
        tat.clear_cache()
        pin = tapi.plan(m, execution=tapi.ExecutionConfig(format="ell"),
                        device="cpu")
        assert pin.format == "ell"            # the pin wins
        assert pin.partition_strategy == auto.partition_strategy
        assert pin.partition_tuning is None   # the stored strategy served

    def test_tuned_pin_wins_over_the_store(self, tmp_path):
        _store(tmp_path)
        m = port(poisson3d(8))
        tapi.plan(m, device="cpu")
        tapi.PLAN_CACHE.clear()
        pinned = TunedParams(n_buckets=8)
        p = tapi.plan(m, execution=tapi.ExecutionConfig(tuned=pinned),
                      device="cpu")
        assert p.tuned == pinned

    def test_plan_cache_stats_surface_disk_counters(self, tmp_path):
        _store(tmp_path)
        tapi.plan(port(poisson3d(8)), device="cpu")
        disk = tapi.PLAN_CACHE.stats()["tune"]["disk"]
        assert disk is not None and disk["saved"] == 1
        assert tapi.PLAN_CACHE.evict() == 1
        tuning.set_store(None)
        assert tapi.PLAN_CACHE.stats()["tune"]["disk"] is None

    def test_incompatible_stored_format_is_ignored(self, tmp_path):
        st = _store(tmp_path)
        m = port(poisson3d(8))
        key = tat.pattern_hash(m)
        st.save(_entry(pattern=key, format="dense"))
        p = tapi.plan(m, execution=tapi.ExecutionConfig(
            candidates=("csr", "ehyb")), device="cpu")
        assert p.format in ("csr", "ehyb")

    @pytest.mark.parametrize("k", [1, 16])
    @pytest.mark.parametrize("name", ["poisson3d_16", "elasticity_8",
                                      "powerlaw_4k", "circuit_4k"])
    def test_warm_plan_decisions_equal_the_reference(self, tmp_path, name,
                                                     k):
        """The plan served from the store takes the reference's decisions:
        format, partition strategy and tuned parameters."""
        _store(tmp_path)
        m = SUITE[name]()
        ex = tapi.ExecutionConfig(k=k)
        cold, warm, delta = _cold_then_warm(port(m), ex)
        assert delta.get("tune_store.hit", 0) == 1
        jp = japi.plan(m, execution=japi.ExecutionConfig(k=k))
        assert warm.format == jp.format
        assert warm.partition_strategy == jp.partition_strategy
        want = jp.tuned.to_dict()
        assert warm.tuned.to_dict() == {k_: want[k_]
                                        for k_ in warm.tuned.to_dict()}


_SCRIPT = r"""
import json, sys
import numpy as np
from repro_torch import api
from repro_torch.core import counters
from repro_torch.core.matrices import SUITE

m = SUITE["poisson3d_16"]()
p = api.plan(m, execution=api.ExecutionConfig(mode="measure"), device="cpu")
op = p.bind(m)
y = (op @ np.ones(m.n)).double().numpy()
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "repro" or k.startswith("repro."))
print(json.dumps({"counters": counters.snapshot(),
                  "identity": list(map(str, p.identity())),
                  "y0": float(y[0]), "bad": bad}))
"""


def _run_plan_subprocess(store_dir, tag):
    env = {**os.environ, "PYTHONPATH": str(SRC),
           "REPRO_TORCH_TUNE_CACHE": str(store_dir)}
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"{tag} subprocess failed:\n{out.stderr}"
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_fresh_process_warm_start_does_zero_tuning_work(tmp_path):
    """A fresh process with a populated store reaches a bound operator with
    zero partitioning passes and zero tuner measurements (counters), and
    its plan identity equals the cold process's; neither imports jax."""
    store = tmp_path / "fleet-cache"
    cold = _run_plan_subprocess(store, "cold")
    assert cold["bad"] == []
    assert cold["counters"].get("partition", 0) >= 1
    assert cold["counters"].get("tune.measured", 0) >= 1
    assert cold["counters"].get("tune_store.saved", 0) >= 1

    warm = _run_plan_subprocess(store, "warm")
    assert warm["bad"] == []
    assert warm["counters"].get("tune_store.hit", 0) == 1
    assert warm["counters"].get("partition", 0) == 0
    assert warm["counters"].get("tune.measured", 0) == 0
    assert warm["identity"] == cold["identity"]
    assert warm["y0"] == pytest.approx(cold["y0"], rel=1e-6)


def test_warm_start_under_a_warning_filter_is_silent(tmp_path):
    """A clean hit emits no warning (only quarantines warn)."""
    _store(tmp_path)
    m = port(poisson3d(8))
    tapi.plan(m, device="cpu")
    tapi.PLAN_CACHE.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tapi.plan(m, device="cpu")

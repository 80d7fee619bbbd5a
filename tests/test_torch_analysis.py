"""The port's static-analysis layer against the JAX package's.

Mirrors ``tests/test_analysis.py``: every seeded corruption is applied to
both packages' containers (and halo plans) and must be named by the same
rule ids; the port's own
pattern-laid tables (``col_rows``, ``er_col_rows``, the compact ER stream
``er_s_*``) are mutated too.  Then a clean sweep of every SUITE matrix ×
the seven formats, ``bind(validate="full")`` refusing a corrupt container,
the dispatch lint on synthetic programs and on every registered apply, and
the port's source lint.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import verify as jverify
from repro.analysis.invariants import check_halo_plan as jcheck_halo_plan
from repro.analysis.jaxpr_lint import _probe_matrix as jprobe
from repro.autotune import build_format as jbuild_format
from repro.core import build_ehyb as jbuild_ehyb
from repro.core.ehyb import build_buckets as jbuild_buckets
from repro.core.ehyb import pack_staircase as jpack_staircase
from repro.core.matrices import SUITE
from repro_torch.analysis import (Finding, errors, summarize, verify,
                                  verify_plan)
from repro_torch.analysis.dispatch_lint import (_probe_matrix, lint_ops,
                                                record_ops,
                                                run_dispatch_lint)
from repro_torch.analysis.invariants import (RULES, check_ehyb_device,
                                             check_packed_device)
from repro_torch.analysis.source_lint import lint_source, run_source_lint
from repro_torch.api import ExecutionConfig, plan
from repro_torch.autotune import available_formats, build_format
from repro_torch.core import counters
from repro_torch.core.ehyb import build_buckets, build_ehyb, pack_staircase
from repro_torch.core.matrices import SparseCSR
from repro_torch.core.spmv import EHYBDevice, EHYBPackedDevice
from repro.dist.halo import build_halo_plan as jbuild_halo_plan
from repro_torch.analysis.invariants import (check_halo_plan,
                                             check_shards_device)
from repro_torch.dist.halo import build_halo_plan
from repro_torch.dist.operator import _shards_from_ehyb


def rules_of(findings):
    return {f.rule for f in findings}


def port(m) -> SparseCSR:
    return SparseCSR(m.n, m.indptr, m.indices, m.data)


@pytest.fixture(scope="module")
def m():
    return jprobe()


@pytest.fixture(scope="module")
def builds(m):
    """(reference host EHYB, port host EHYB) of the probe matrix at the
    reference test's geometry (4 partitions of 16)."""
    return (jbuild_ehyb(m, n_parts=4, vec_size=16),
            build_ehyb(port(m), n_parts=4, vec_size=16))


def test_probe_matrix_is_the_reference_one(m):
    t = _probe_matrix()
    np.testing.assert_array_equal(t.indptr, m.indptr)
    np.testing.assert_array_equal(t.indices, m.indices)
    np.testing.assert_array_equal(t.data, m.data)


def test_finding_record():
    f = Finding("error", "EHYB.ell_cols", "index-bound.ell-local", "boom")
    assert "index-bound.ell-local" in str(f) and "[error]" in str(f)
    with pytest.raises(ValueError):
        Finding("fatal", "x", "r", "m")
    fs = [f, Finding("warning", "y", "bf16-accum", "w"),
          Finding("info", "z", "note", "n")]
    assert errors(fs) == [f]
    assert summarize(fs) == {"bf16-accum": 1, "index-bound.ell-local": 1,
                             "note": 1}
    assert {r for r in RULES if r.startswith("halo-")} == {
        "halo-coverage", "halo-push-race", "halo-accounting"}


# ---------------------------------------------------------------------------
# corruption regressions: host EHYB family, both packages
# ---------------------------------------------------------------------------

def _oob_uint16_col(e):
    bad = dataclasses.replace(e, ell_cols=e.ell_cols.copy())
    bad.ell_cols[0, 0, 0] = e.vec_size          # one past the tile edge
    return bad


def _oob_er_global_col(e):
    bad = dataclasses.replace(e, er_cols=e.er_cols.copy())
    assert bad.er_cols.size, "probe matrix must have ER rows"
    bad.er_cols.reshape(-1)[0] = e.n_pad
    return bad


def _non_bijective_perm(e):
    p = e.perm.copy()
    p[1] = p[0]
    return dataclasses.replace(e, perm=p)


def _swapped_inverse(e):
    return dataclasses.replace(e, inv_perm=np.roll(e.inv_perm, 1))


def _stale_fill_plan(e):
    fp = dict(e.fill_plan)
    fp["ell_src"] = fp["ell_src"].copy()
    fp["ell_src"][0] = fp["ell_src"][1]         # entry duplicated, one lost
    return dataclasses.replace(e, fill_plan=fp)


def _duplicate_fill_dst(e):
    fp = dict(e.fill_plan)
    fp["ell_dst"] = fp["ell_dst"].copy()
    fp["ell_dst"][0] = fp["ell_dst"][1]
    return dataclasses.replace(e, fill_plan=fp)


def _padding_violation(e):
    ev = e.ell_vals.copy()
    ev[-1, -1, -1] = 7.0                        # dead slot made nonzero
    return dataclasses.replace(e, ell_vals=ev)


def _width_tampering(e):
    pw = e.part_widths.copy()
    pw[0] += 1
    return dataclasses.replace(e, part_widths=pw)


def _nonfinite_values(e):
    ev = e.ell_vals.copy()
    ev[tuple(np.argwhere(ev != 0)[0])] = np.nan
    return dataclasses.replace(e, ell_vals=ev)


def _broken_staircase(e, pack):
    pk = pack(e)
    cr = pk.col_rows.copy()
    p = int(np.argmax(cr[:, 0] >= 2))
    cr[p, 0], cr[p, 1] = cr[p, 1], cr[p, 0] + 1  # widths increase in k
    cs = np.zeros_like(pk.col_starts)
    cs[:, 1:] = np.cumsum(cr, axis=1)            # keep starts consistent
    return dataclasses.replace(pk, col_rows=cr, col_starts=cs)


def _bucket_cover_violation(e, buckets):
    b = buckets(e)
    ids = [c.copy() for c in b.part_ids]
    donor = next(i for i, c in enumerate(ids) if len(c))
    ids[donor][0] = ids[donor][-1] if len(ids[donor]) > 1 else \
        (ids[donor][0] + 1) % e.n_parts
    return dataclasses.replace(b, part_ids=ids)


HOST_MUTATIONS = {
    "oob_uint16_col": (lambda e, j: _oob_uint16_col(e),
                       "index-bound.ell-local"),
    "oob_er_global_col": (lambda e, j: _oob_er_global_col(e),
                          "index-bound.er-global"),
    "non_bijective_perm": (lambda e, j: _non_bijective_perm(e),
                           "perm-bijection"),
    "swapped_inverse": (lambda e, j: _swapped_inverse(e), "perm-bijection"),
    "stale_fill_plan": (lambda e, j: _stale_fill_plan(e),
                        "fill-plan-bijection"),
    "duplicate_fill_dst": (lambda e, j: _duplicate_fill_dst(e),
                           "fill-plan-bijection"),
    "padding_violation": (lambda e, j: _padding_violation(e),
                          "padding-sentinel"),
    "width_tampering": (lambda e, j: _width_tampering(e),
                        "width-consistency"),
    "nonfinite_values": (lambda e, j: _nonfinite_values(e), "value-finite"),
    "broken_staircase": (lambda e, j: _broken_staircase(
        e, jpack_staircase if j else pack_staircase), "staircase-monotone"),
    "bucket_cover_violation": (lambda e, j: _bucket_cover_violation(
        e, jbuild_buckets if j else build_buckets), "bucket-cover"),
}


@pytest.mark.parametrize("case", list(HOST_MUTATIONS))
def test_host_mutation_same_rules_as_reference(builds, case):
    mutate, rule = HOST_MUTATIONS[case]
    je, te = builds
    jr = rules_of(jverify(mutate(je, True)))
    tr = rules_of(verify(mutate(te, False)))
    assert rule in tr
    assert tr == jr


def test_clean_host_builds(builds):
    je, te = builds
    assert verify(te) == [] == jverify(je)
    assert verify(pack_staircase(te)) == []
    assert verify(build_buckets(te)) == []


# ---------------------------------------------------------------------------
# corruption regressions: device containers (all seven formats)
# ---------------------------------------------------------------------------

def _set(obj, field, idx, value, jax_side: bool):
    a = getattr(obj, field)
    if jax_side:
        return dataclasses.replace(obj, **{
            field: jnp.asarray(a).at[idx].set(value)})
    t = a.clone()
    t[idx] = value
    return dataclasses.replace(obj, **{field: t})


DEVICE_MUTATIONS = {
    "csr_cols": ("csr", lambda d, m, j: _set(d, "cols", 0, m.n, j),
                 "index-bound.stream"),
    "ell_cols": ("ell", lambda d, m, j: _set(d, "cols", (0, 0), -1, j),
                 "index-bound.stream"),
    "hyb_coo_rows": ("hyb", lambda d, m, j: _set(d, "coo_rows", 0, m.n, j),
                     "index-bound.stream"),
    "ehyb_ell_cols": ("ehyb", lambda d, m, j: _set(
        d, "ell_cols", (0, 0, 0), d.vec_size, j), "index-bound.ell-local"),
    "ehyb_er_p_rows": ("ehyb", lambda d, m, j: _set(
        d, "er_p_rows", (0, 0), d.vec_size, j), "index-bound.er-global"),
    "packed_cols": ("ehyb_packed", lambda d, m, j: _set(
        d, "packed_cols", (0, 0), d.vec_size, j), "index-bound.ell-local"),
}


@pytest.mark.parametrize("case", list(DEVICE_MUTATIONS))
def test_device_mutation_same_rules_as_reference(m, case):
    fmt, mutate, rule = DEVICE_MUTATIONS[case]
    jd, _ = jbuild_format(fmt, m, shared={})
    td = build_format(fmt, port(m), None, {}, device="cpu")
    jr = rules_of(jverify(mutate(jd, m, True)))
    tr = rules_of(verify(mutate(td, m, False)))
    assert rule in tr
    assert tr == jr


def test_device_buckets_corruption_same_rules(m):
    jd, _ = jbuild_format("ehyb_bucketed", m, shared={})
    td = build_format("ehyb_bucketed", port(m), None, {}, device="cpu")

    def mutate(ids, take):
        donor = next(i for i, c in enumerate(ids) if c.size)
        c = ids[donor]
        v = take(c, -1) if c.size > 1 else (take(c, 0) + 1) % td.n_parts
        return donor, v
    jids = tuple(jnp.asarray(c) for c in jd.part_ids)
    donor, v = mutate(jids, lambda c, i: int(c[i]))
    jbad = dataclasses.replace(jd, part_ids=jids[:donor] + (
        jids[donor].at[0].set(v),) + jids[donor + 1:])
    tids = [c.clone() for c in td.part_ids]
    tids[donor][0] = v
    tbad = dataclasses.replace(td, part_ids=tuple(tids))
    assert "bucket-cover" in rules_of(verify(tbad))
    assert rules_of(verify(tbad)) == rules_of(jverify(jbad))


def test_dense_corruption_same_rules(m):
    jd, _ = jbuild_format("dense", m, shared={})
    td = build_format("dense", port(m), None, {}, device="cpu")
    vals = td.vals.clone()
    vals[0, 0] = float("nan")
    tr = rules_of(verify(dataclasses.replace(td, vals=vals)))
    assert tr == rules_of(jverify(jd.at[0, 0].set(jnp.nan))) \
        == {"value-finite"}
    tr = rules_of(verify(dataclasses.replace(td, vals=td.vals[:, :-1])))
    assert tr == rules_of(jverify(jd[:, :-1])) == {"width-consistency"}
    assert rules_of(verify(td.vals[:, :-1])) == {"width-consistency"}


# ---------------------------------------------------------------------------
# the port's pattern-laid tables: col_rows, er_col_rows, er_s_*
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ehyb_er(builds):
    """A port host build with ER entries, its uniform and packed device
    containers on the CPU."""
    _, e = builds
    assert e.fill_plan["n_er_live"] > 1
    return (e, EHYBDevice.from_ehyb(e, device="cpu"),
            EHYBPackedDevice.from_packed(pack_staircase(e), device="cpu"))


def _clone_set(d, field, idx, value):
    t = getattr(d, field).clone()
    t[idx] = value if not callable(value) else value(t[idx])
    return dataclasses.replace(d, **{field: t})


# (field, index, value or a function of the old entry, rule, whether only
# the host build's pattern reveals it)
TABLE_MUTATIONS = {
    "col_rows_widened": ("col_rows", (0, 0), lambda v: v + 1,
                         "width-consistency", True),
    "col_rows_increasing": ("col_rows", (0, -1), lambda v: 10 ** 4,
                            "width-consistency", False),
    "er_col_rows_shrunk": ("er_col_rows", 0, lambda v: v - 1,
                           "width-consistency", True),
    "er_col_rows_increasing": ("er_col_rows", -1, lambda v: 10 ** 6,
                               "width-consistency", False),
    "er_s_part_ptr": ("er_s_part_ptr", 1, lambda v: v + 10 ** 6,
                      "fill-plan-bijection", False),
    "er_s_row_ptr": ("er_s_row_ptr", -1, lambda v: v + 1,
                     "fill-plan-bijection", False),
    "er_s_rows_oob": ("er_s_rows", 0, 16, "index-bound.er-global", False),
    "er_s_rows_shared": ("er_s_rows", 1, None, "fill-plan-bijection",
                         False),
    "er_s_cols_oob": ("er_s_cols", 0, 64, "index-bound.er-global", False),
    "er_s_cols_moved": ("er_s_cols", 0, lambda v: (v + 1) % 64,
                        "fill-plan-bijection", True),
}


@pytest.mark.parametrize("layout", ["uniform", "packed"])
@pytest.mark.parametrize("case", list(TABLE_MUTATIONS))
def test_port_table_mutation_caught(ehyb_er, case, layout):
    e, du, dp = ehyb_er
    d = du if layout == "uniform" else dp
    field, idx, value, rule, needs_host = TABLE_MUTATIONS[case]
    if case == "er_s_rows_shared":
        # the second stream row of partition 0 takes the first's local row
        assert int(d.er_s_part_ptr[1]) >= 2
        value = int(d.er_s_rows[0])
    bad = _clone_set(d, field, idx, value)
    check = check_ehyb_device if layout == "uniform" else \
        check_packed_device
    assert check(d, e) == [] and check(d) == []
    assert rule in rules_of(check(bad, e))
    if not needs_host:
        assert rule in rules_of(check(bad))


def test_packed_col_rows_against_col_starts(ehyb_er):
    _, _, dp = ehyb_er
    bad = _clone_set(dp, "col_rows", (0, 0), lambda v: v + 1)
    assert "width-consistency" in rules_of(check_packed_device(bad))


@pytest.mark.parametrize("fmt", ["ehyb", "ehyb_packed"])
def test_operator_verify_reads_the_plans_host_build(fmt):
    """``verify(op)`` holds an EHYB-family operator's tables to its plan's
    host build: a mutation only the pattern reveals is caught."""
    mm = port(SUITE["powerlaw_4k"]())
    p = plan(mm, execution=ExecutionConfig(format=fmt,
                                           partition_method="bfs"),
             device="cpu")
    op = p.bind(mm, validate="full")
    assert verify(op) == [] and verify_plan(p) == []
    bad = dataclasses.replace(op, obj=_clone_set(
        op.obj, "er_col_rows", 0, lambda v: v - 1))
    assert "width-consistency" in rules_of(verify(bad))


# ---------------------------------------------------------------------------
# clean-pass sweep: zero false positives over the seven formats × SUITE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SUITE))
def test_clean_sweep_suite(name):
    mm = port(SUITE[name]())
    for fmt in available_formats():
        p = plan(mm, execution=ExecutionConfig(format=fmt,
                                               partition_method="bfs"),
                 device="cpu")
        op = p.bind(mm, validate="full")     # raises on error findings
        assert verify(op) == [], f"false positive: {fmt} on {name}"
        assert verify_plan(p) == []
        assert verify(p.partition) == []


def test_operator_and_plan_verify_clean_on_bf16_and_tensor_binds(m):
    mm = port(m)
    for fmt in available_formats():
        p = plan(mm, execution=ExecutionConfig(format=fmt), device="cpu")
        op = p.bind(mm, dtype=torch.bfloat16, validate="full")
        assert verify(op) == []
        vals = torch.as_tensor(mm.data * 2.0)
        assert verify(p.bind(vals, validate="full")) == []


# ---------------------------------------------------------------------------
# bind(validate="full")
# ---------------------------------------------------------------------------

def test_bind_full_rejects_corrupt_container(m, monkeypatch):
    from repro_torch.autotune import FORMATS

    mm = port(m)
    p = plan(mm, execution=ExecutionConfig(format="ehyb"), device="cpu")
    spec = FORMATS["ehyb"]          # frozen: swap the registry entry
    monkeypatch.setitem(
        FORMATS, "ehyb", dataclasses.replace(
            spec, invariants=lambda obj, host=None: [
                Finding("error", "EHYBDevice", "perm-bijection",
                        "seeded")]))
    with pytest.raises(ValueError, match="perm-bijection"):
        p.bind(mm.data, validate="full")
    with pytest.raises(ValueError, match="perm-bijection"):
        p.bind(torch.as_tensor(mm.data), validate="full")
    # default bind keeps only the cheap checks — unaffected by the hook
    p.bind(mm.data)


@pytest.mark.parametrize("field,rule", [
    ("packed_cols", "index-bound.ell-local"),
    ("er_s_cols", "index-bound.er-global")])
def test_bind_full_rejects_a_corrupt_structure(field, rule):
    """A corrupt structural table (what every rebind scatters into) is
    refused by ``validate="full"`` before the operator exists; the default
    bind does not look."""
    mm = port(SUITE["powerlaw_4k"]())
    p = plan(mm, execution=ExecutionConfig(format="ehyb_packed",
                                           partition_method="bfs"),
             device="cpu")
    p.bind(mm)
    value = p.vec_size if field == "packed_cols" else p.partition.n_pad
    bad = dataclasses.replace(p, _structure=_clone_set(
        p._structure, field, 0 if field == "er_s_cols" else (0, 0), value),
        _last={}, _guards={})
    with pytest.raises(ValueError, match=rule):
        bad.bind(mm.data * 2.0, validate="full")
    with pytest.raises(ValueError, match=rule):
        bad.bind(torch.as_tensor(mm.data * 2.0), validate="full")
    assert rule in rules_of(verify(bad.bind(mm.data * 2.0)))


def test_verify_rejects_unknown_objects():
    with pytest.raises(TypeError):
        verify(object())
    with pytest.raises(TypeError):
        verify_plan(object())


# ---------------------------------------------------------------------------
# dispatch lint
# ---------------------------------------------------------------------------

def test_dispatch_flags_host_sync():
    fs = lint_ops(record_ops(lambda: torch.ones(4).sum().item()), "t")
    assert rules_of(fs) == {"host-callback"}


def test_dispatch_flags_bf16_accumulation():
    a = torch.zeros((4, 4), dtype=torch.bfloat16)
    fs = lint_ops(record_ops(lambda: a @ a), "t")
    assert "bf16-accum" in rules_of(fs)
    assert all(f.severity == "warning" for f in fs)
    fs = lint_ops(record_ops(lambda: a.sum(0)), "t")
    assert "bf16-accum" in rules_of(fs)
    y = torch.zeros(4, dtype=torch.bfloat16)
    fs = lint_ops(record_ops(lambda: y.index_add_(
        0, torch.tensor([0, 0]), torch.ones(2, dtype=torch.bfloat16))), "t")
    assert "bf16-accum" in rules_of(fs)


def test_dispatch_accepts_fp32_accumulation():
    a = torch.zeros((4, 4), dtype=torch.bfloat16)
    assert lint_ops(record_ops(lambda: (a.float() @ a.float())
                               .to(torch.bfloat16)), "t") == []


def test_dispatch_flags_fp64_downcast():
    x = torch.zeros(4, dtype=torch.float64)
    assert rules_of(lint_ops(record_ops(lambda: x.float() * 2), "t")) == \
        {"dtype-downcast"}
    assert lint_ops(record_ops(lambda: x * 2), "t") == []


def test_dispatch_sweep_registered_formats_has_no_errors():
    fs = run_dispatch_lint()
    assert errors(fs) == []
    sites = {f.site for f in fs}
    assert all(s.split(":")[0] in available_formats() for s in sites)


def test_dispatch_sweep_reports_a_failing_apply(monkeypatch):
    from repro_torch.autotune import FORMATS

    def broken(obj, x):
        raise RuntimeError("boom")
    monkeypatch.setitem(FORMATS, "ell", dataclasses.replace(
        FORMATS["ell"], apply=broken))
    fs = run_dispatch_lint(formats=["ell"])
    assert rules_of(fs) == {"trace-failure"} and len(fs) == 6


# ---------------------------------------------------------------------------
# source lint
# ---------------------------------------------------------------------------

def test_lint_broad_except():
    src = ("try:\n    pass\n"
           "except Exception:\n    pass\n")
    assert rules_of(lint_source(src, "t.py")) == {"BLE001"}
    tagged = ("try:\n    pass\n"
              "except Exception:  # noqa: BLE001 — probe\n    pass\n")
    assert lint_source(tagged, "t.py") == []


def test_lint_bare_except_never_taggable():
    src = ("try:\n    pass\n"
           "except:  # noqa: BLE002\n    pass\n")
    assert rules_of(lint_source(src, "t.py")) == {"BLE002"}
    src2 = ("try:\n    pass\n"
            "except BaseException:\n    raise\n")
    assert rules_of(lint_source(src2, "t.py")) == {"BLE002"}


def test_lint_module_scope_torch():
    src = ("import torch\n"
           "TABLE = torch.arange(8)\n")
    assert rules_of(lint_source(src, "t.py")) == {"TCH001"}
    src = ("import torch as th\n"
           "class C:\n    ok = th.cuda.is_available()\n")
    assert rules_of(lint_source(src, "t.py")) == {"TCH001"}
    src = "from torch import zeros\nZ = zeros(3)\n"
    assert rules_of(lint_source(src, "t.py")) == {"TCH001"}
    ok = ("import torch\n"
          "CPU = torch.device('cpu')\n"
          "CODE = {torch.float32: 0}\n"
          "def f():\n    return torch.arange(8)\n")
    assert lint_source(ok, "t.py") == []


def test_lint_deprecated_shims():
    src = "from repro_torch.core.spmv import build_spmv\n"
    assert rules_of(lint_source(src, "t.py", "repro_torch.other")) == \
        {"DEP001"}
    # the defining module itself is exempt
    assert lint_source(src, "t.py", "repro_torch.core.spmv") == []


@pytest.mark.parametrize("decorator,imports", [
    ("@torch.compile", "import torch\n"),
    ("@torch.compile(mode='max-autotune')", "import torch\n"),
    ("@torch.jit.script", "import torch\n"),
    ("@triton.jit", "import triton\n"),
    ("@jit", "from triton import jit\n")])
def test_lint_wallclock_under_a_compiler(decorator, imports):
    src = (f"import time\n{imports}"
           f"{decorator}\n"
           "def f(x):\n"
           "    t = time.perf_counter()\n"
           "    return x + t\n")
    assert rules_of(lint_source(src, "t.py")) == {"JIT001"}
    ok = ("import time\n"
          "def g(x):\n"
          "    return time.perf_counter()\n")
    assert lint_source(ok, "t.py") == []


def test_port_source_is_lint_clean():
    """``src/repro_torch/``, ``chip_smoke.py`` and ``tools/`` carry no
    untagged broad excepts, module-scope torch work, deprecated-shim use or
    wall-clock-under-a-compiler."""
    assert run_source_lint() == []


def test_analysis_cli_is_clean_against_the_port_baseline(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["-q"]) == 0
    assert "clean against baseline" in capsys.readouterr().out


def test_verify_counts_no_structure_pass(builds):
    """The verifier reads the containers; it builds and partitions
    nothing."""
    _, e = builds
    before = counters.snapshot()
    verify(e)
    verify(EHYBDevice.from_ehyb(e, device="cpu"))
    after = counters.snapshot()
    for k in ("partition", "build_ehyb", "pack_staircase"):
        assert after.get(k, 0) == before.get(k, 0)


# ---------------------------------------------------------------------------
# halo plan conservation laws and a rank's shard, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def halo_plans(builds):
    """(reference plan, reference build, port plan, port build) at 4
    devices, as the reference test plans them."""
    je, te = builds
    return jbuild_halo_plan(je, 4), je, build_halo_plan(te, 4), te


def _dup_push_row(hp):
    d = next(d for d in range(hp.n_dev) if hp.counts_push[d].sum() >= 2)
    rr = hp.rp_rows.copy()
    rr[d, 1] = rr[d, 0]                 # two scatter-adds on one row
    return dataclasses.replace(hp, rp_rows=rr)


def _tampered_send(hp):
    pair = np.argwhere((np.asarray(hp.direction) == 1)
                       & (np.asarray(hp.counts_fetch) > 0))
    d, s = pair[0]
    si = hp.send_idx.copy()
    si[s, d, 0] += 1                    # fetch the wrong column
    return dataclasses.replace(hp, send_idx=si)


HALO_MUTATIONS = {
    "duplicate_push_row": _dup_push_row,
    "word_accounting": lambda hp: dataclasses.replace(
        hp, halo_words=hp.halo_words + 1),
    "dropped_coverage": lambda hp: dataclasses.replace(
        hp, fer_src=hp.fer_src[:-1], fer_dst=hp.fer_dst[:-1]),
    "tampered_send": _tampered_send,
}


def test_halo_plan_clean_on_both(halo_plans):
    jhp, je, thp, te = halo_plans
    assert jcheck_halo_plan(jhp, je) == [] and check_halo_plan(thp, te) == []
    assert verify_plan(thp, te) == []
    info = check_halo_plan(thp)
    assert errors(info) == [] and any(f.severity == "info" for f in info)


@pytest.mark.parametrize("case", list(HALO_MUTATIONS))
def test_halo_mutation_same_rules_as_reference(halo_plans, case):
    jhp, je, thp, te = halo_plans
    want = rules_of(jcheck_halo_plan(HALO_MUTATIONS[case](jhp), je))
    got = rules_of(check_halo_plan(HALO_MUTATIONS[case](thp), te))
    assert got == want and got, (case, got, want)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_shards_clean_and_corruptions_caught(builds, n_dev):
    """Every rank's shard of the probe matrix verifies clean; a fetch
    column past the halo, a push slot past the buffer, a widening
    ``fer_col_rows`` and a NaN value are each named by their rule."""
    te = builds[1]
    hp = build_halo_plan(te, n_dev)
    shards = [_shards_from_ehyb(te, hp, torch.float32, torch.device("cpu"),
                                r)[0] for r in range(n_dev)]
    for d in shards:
        assert check_shards_device(d) == [] and verify(d) == []
    d = next(d for d in shards if d.fer_cols.numel() and d.pe_dst.numel())
    cases = {
        "fer_cols": ("index-bound.er-global", lambda t: t.fill_(
            d.local_size + d.recv_sel.numel())),
        "pe_dst": ("index-bound.er-global", lambda t: t.fill_(
            d.n_dev * d.seg_len)),
        "fer_col_rows": ("width-consistency", lambda t: t.copy_(
            torch.arange(t.numel(), dtype=t.dtype))),
        "fer_vals": ("value-finite", lambda t: t.fill_(float("nan"))),
        "ell_cols": ("index-bound.ell-local", lambda t: t.fill_(
            d.vec_size)),
    }
    for field, (rule, mutate) in cases.items():
        bad = dataclasses.replace(d, **{field: mutate(
            getattr(d, field).clone())})
        assert rule in rules_of(check_shards_device(bad)), field


def test_collective_axis_lint(monkeypatch):
    """Every collective of the sharded applies and solves names the plan's
    group; an exchange on the default group is flagged."""
    from repro_torch.analysis import dispatch_lint
    from repro_torch.dist import operator as dop

    assert dispatch_lint.run_collective_lint() == []
    sites = [s for s, _, _ in dispatch_lint.sharded_paths()]
    assert {"sharded:apply:k1", "sharded:permuted:k4",
            "sharded:solve:cg", "sharded:solve:bicgstab"} <= set(sites)
    real = dop.group_exchange
    monkeypatch.setattr(dop, "group_exchange", lambda group: real(None))
    bad = dispatch_lint.run_collective_lint()
    assert bad and rules_of(bad) == {"collective-axis"}
    assert {f.site for f in bad} == set(sites)


def test_mesh_collective_axis_lint(monkeypatch):
    """The mesh path's collectives — the MoE's all-to-alls and token
    gathers, the step's parameter gathers, gradient reductions and norm
    sums — each name a group of the mesh; one on the default group is
    flagged at every mesh site."""
    from repro_torch.analysis import dispatch_lint
    from repro_torch.models import shard_ctx

    sites = [s for s, _, _ in dispatch_lint.mesh_paths()]
    assert {"mesh:moe:expert", "mesh:moe:ffn", "mesh:step:llama3_2_1b",
            "mesh:step:moonshot_v1_16b_a3b"} <= set(sites)
    for site, mesh, thunk in dispatch_lint.mesh_paths():
        calls = dispatch_lint.record_collectives(thunk)
        names = {n for n, _ in calls}
        assert "all_reduce" in names, site
        if site in ("mesh:moe:expert", "mesh:step:moonshot_v1_16b_a3b"):
            assert "all_to_all_single" in names, site
        assert dispatch_lint.lint_collectives(calls, mesh, site) == []
    monkeypatch.setattr(shard_ctx, "axis_group", lambda mesh, axes: None)
    bad = dispatch_lint.run_collective_lint()
    assert bad and rules_of(bad) == {"collective-axis"}
    assert {f.site for f in bad} == set(sites)

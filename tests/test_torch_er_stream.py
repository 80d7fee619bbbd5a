"""The compact ER stream (``repro_torch.core.ehyb.er_stream``, the
containers' ``er_s_*``) and the plain K = 1 fused applies that read it;
``er_col_rows`` (the global ER table's live prefixes) and the plain
version of the ER kernel, which reads only those prefixes.

For every SUITE matrix under the ``natural`` and ``bfs`` partitions, the
stream holds exactly the live slots of the padded ``er_p_*`` tiles, in
row-major order, with distinct local rows inside a partition and rows in
descending length; the live slots are found here from the JAX package's own
build (its ``fill_plan`` and ER grouping), independently of the port's
``er_stream``.  The plain uniform apply on the stream is held against
``repro.kernels.ehyb_spmv.ehyb_fused_pallas`` in interpret mode and
``repro.core.spmv.ehyb_spmv_permuted``; the packed wrapper's CPU path
against ``ehyb_spmv_permuted`` (the packed Pallas kernel cannot run on the
installed jax).  Tolerance: max|Δ| / max(max|y_ref|, 1) ≤ 1e-4 in fp32, as
in ``tests/test_spmv_conformance.py``.  ``er_col_rows`` is held against the
live counts of the JAX build's pattern, the ER kernel's plain version
against ``er_pallas`` in interpret mode and ``ref.er_ref``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ehyb as jehyb
from repro.core import matrices as jmat
from repro.core.spmv import EHYBDevice as JEHYBDevice
from repro.core.spmv import ehyb_spmv_permuted as jax_ehyb_spmv_permuted
from repro.kernels.ehyb_spmv import ehyb_fused_pallas, er_pallas
from repro_torch import convert
from repro_torch.core import ehyb as tehyb
from repro_torch.core import matrices as tmat
from repro_torch.core.spmv import (EHYBDevice, EHYBPackedDevice,
                                   _fused_er_parts)
from repro_torch.kernels import ehyb_spmv as K
from repro_torch.kernels import ops, ref

TOL = 1e-4
METHODS = ("natural", "bfs")
STATIC = ("n", "n_pad", "n_parts", "vec_size", "has_er")


def rel(y, y_ref):
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    return np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1.0)


def with_zeros(m, every=7):
    """``m`` with every ``every``-th stored value set to an explicit zero:
    the same pattern, other values."""
    data = m.data.copy()
    data[::every] = 0.0
    return type(m)(n=m.n, indptr=m.indptr, indices=m.indices, data=data)


def diagonal(m):
    """The diagonal of ``m`` (ER-free under any partition)."""
    rows = np.repeat(np.arange(m.n), m.row_lengths())
    on = rows == m.indices
    return rows[on], m.indices[on], m.data[on]


MATRICES = {**{k: (lambda k=k: (tmat.SUITE[k](), jmat.SUITE[k]()))
               for k in tmat.SUITE},
            "powerlaw_4k_zeros": lambda: (with_zeros(tmat.SUITE[
                "powerlaw_4k"]()), with_zeros(jmat.SUITE["powerlaw_4k"]())),
            "poisson3d_16_diag": lambda: (
                tmat.from_coo(4096, *diagonal(tmat.SUITE["poisson3d_16"]())),
                jmat.from_coo(4096, *diagonal(jmat.SUITE["poisson3d_16"]())))}


def builds(name, method):
    tm, jm = MATRICES[name]()
    return tm, tehyb.build_ehyb(tm, method=method), \
        jehyb.build_ehyb(jm, method=method)


def live_mask(je) -> np.ndarray:
    """(P, E, We) bool: the live slots of the JAX build's grouped ER
    tiles, from its pattern (``fill_plan["er_dst"]``) and its grouping."""
    g = jehyb.group_er_by_partition(je)
    p, ep, we = g["er_p_vals"].shape
    grouped = np.full(je.er_rows, -1, dtype=np.int64)
    grouped[g["src"]] = g["own"] * ep + g["slot"]
    slot, k = np.divmod(je.fill_plan["er_dst"], we)
    mask = np.zeros((p * ep, we), dtype=bool)
    mask[grouped[slot], k] = True
    return mask.reshape(p, ep, we)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_stream_holds_the_live_slots_in_order(name, method):
    tm, te, je = builds(name, method)
    d = EHYBDevice.from_ehyb(te, torch.float64, device="cpu")
    mask = live_mask(je)
    jg = jehyb.group_er_by_partition(je)
    part_ptr, row_ptr, rows, cols, vals = (t.numpy() for t in d.er_stream())
    live_rows = mask.any(axis=2)                          # (P, E)
    # every entry of the pattern outside the partitions is in the stream
    assert len(vals) == tm.nnz - te.nnz_in == mask.sum()
    np.testing.assert_array_equal(vals, jg["er_p_vals"][mask])
    np.testing.assert_array_equal(cols, jg["er_p_cols"][mask])
    np.testing.assert_array_equal(rows, jg["er_p_rows"][live_rows])
    np.testing.assert_array_equal(np.diff(part_ptr), live_rows.sum(axis=1))
    lens = np.diff(row_ptr)
    np.testing.assert_array_equal(lens, mask.sum(axis=2)[live_rows])
    assert (lens > 0).all()
    for p in range(te.n_parts):
        r = slice(part_ptr[p], part_ptr[p + 1])
        assert len(np.unique(rows[r])) == len(rows[r])    # distinct rows
        assert (np.diff(lens[r]) <= 0).all()              # longest first
    assert d.has_er == bool(len(vals))
    # the packed container carries the same stream
    pk = EHYBPackedDevice.from_packed(tehyb.pack_staircase(te),
                                      torch.float64, device="cpu")
    for a, b in zip(pk.er_stream(), d.er_stream()):
        assert torch.equal(a, b)


def test_stream_keeps_stored_zeros():
    tm, te, _ = builds("powerlaw_4k_zeros", "bfs")
    vals = EHYBDevice.from_ehyb(te, device="cpu").er_s_vals
    assert len(vals) == tm.nnz - te.nnz_in
    assert int((vals == 0).sum()) > 0                    # zeros kept


def test_er_free_stream_is_empty():
    _, te, _ = builds("poisson3d_16_diag", "bfs")
    d = EHYBDevice.from_ehyb(te, device="cpu")
    assert not d.has_er
    assert d.er_s_vals.numel() == d.er_s_rows.numel() == 0
    assert torch.equal(d.er_s_part_ptr,
                       torch.zeros(te.n_parts + 1, dtype=torch.int32))


def test_stream_raises_on_a_shared_local_row():
    _, te, _ = builds("powerlaw_4k", "bfs")
    g = tehyb.group_er_by_partition(te)          # memoized on te
    p = int(np.argmax(np.bincount(g["own"])))
    assert (g["own"] == p).sum() >= 2
    g["er_p_rows"][p, 1] = g["er_p_rows"][p, 0]
    with pytest.raises(ValueError, match="share a local row"):
        tehyb.er_stream(te)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plain_stream_apply_matches_jax(name, method):
    _, te, je = builds(name, method)
    x_new = np.random.default_rng(5).standard_normal(te.n_pad)
    xt = torch.as_tensor(x_new, dtype=torch.float32)
    jd = JEHYBDevice.from_ehyb(je, jnp.float32)
    want_permuted = np.asarray(jax_ehyb_spmv_permuted(
        jd, jnp.asarray(x_new, jnp.float32)), np.float64)
    d = EHYBDevice.from_ehyb(te, device="cpu")
    n0 = K.ehyb_fused.launches
    got = ops.ehyb_spmv_fused_permuted(d, xt)       # CPU -> plain version
    assert K.ehyb_fused.launches == n0              # no kernel launched
    assert got.dtype == torch.float32 and got.shape == (te.n_pad,)
    assert rel(got, want_permuted) <= TOL
    want = ehyb_fused_pallas(jnp.asarray(x_new, jnp.float32)[:, None],
                             jd.ell_vals, jd.ell_cols, jd.er_p_vals,
                             jd.er_p_cols, jd.er_p_rows, interpret=True)[:, 0]
    assert rel(got, np.asarray(want, np.float64)) <= TOL
    # the compact ER part alone equals the padded tiles' plain ER part
    er = ref.er_stream_ref(xt[:, None], *d.er_stream(), d.vec_size)
    er_tiles = _fused_er_parts(xt[:, None], d.er_p_vals, d.er_p_cols,
                               d.er_p_rows, d.vec_size).reshape(-1, 1)
    torch.testing.assert_close(er, er_tiles, rtol=1e-5, atol=1e-5)
    pk = EHYBPackedDevice.from_packed(tehyb.pack_staircase(te),
                                      device="cpu")
    n0 = K.ehyb_packed_fused.launches
    got_p = ops.ehyb_spmv_packed_permuted(pk, xt)
    assert K.ehyb_packed_fused.launches == n0
    assert rel(got_p, want_permuted) <= TOL


def jax_leaves(jd):
    """The JAX container's array leaves (numpy) and static fields."""
    names = [f for f in jd.__dataclass_fields__
             if not isinstance(getattr(jd, f), (int, bool, tuple))]
    return ({f: np.asarray(getattr(jd, f)) for f in names},
            {k: getattr(jd, k) for k in STATIC})


@pytest.mark.parametrize("kind", ["EHYBDevice", "EHYBPackedDevice"])
@pytest.mark.parametrize("name", ["powerlaw_4k", "circuit_4k"])
def test_converted_container_lays_out_the_stream_from_host(name, kind):
    """JAX leaves plus their host build give the stream and ``col_rows`` of
    the port's own container on the same matrix, bit for bit."""
    _, te, je = builds(name, "bfs")
    jd = JEHYBDevice.from_ehyb(je, jnp.float32)
    if kind == "EHYBPackedDevice":
        from repro.core.spmv import EHYBPackedDevice as JEHYBPackedDevice
        jd = JEHYBPackedDevice.from_packed(jehyb.pack_staircase(je),
                                           jnp.float32)
    leaves, static = jax_leaves(jd)
    got = convert.device_container(kind, leaves, static, device="cpu",
                                   host=je)
    want = EHYBDevice.from_ehyb(te, device="cpu")
    for a, b in zip(got.er_stream(), want.er_stream()):
        assert torch.equal(a, b)
    if kind == "EHYBDevice":
        assert torch.equal(got.col_rows, want.col_rows)


def test_converted_container_needs_a_matching_host():
    """``device_container`` raises without ``host=``, and when the host was
    partitioned otherwise or groups its ER rows into other tiles than the
    leaves: the stream's gather positions would then index the wrong
    slots."""
    _, _, je = builds("powerlaw_4k", "bfs")
    leaves, static = jax_leaves(JEHYBDevice.from_ehyb(je, jnp.float32))
    with pytest.raises(ValueError, match="host="):
        convert.device_container("EHYBDevice", leaves, static, device="cpu")
    _, _, je_nat = builds("powerlaw_4k", "natural")
    assert not np.array_equal(je_nat.perm, je.perm)
    with pytest.raises(ValueError, match="permutation"):
        convert.device_container("EHYBDevice", leaves, static, device="cpu",
                                 host=je_nat)
    cut = dict(leaves, er_p_vals=leaves["er_p_vals"][:, :-1],
               er_p_cols=leaves["er_p_cols"][:, :-1])
    with pytest.raises(ValueError, match="groups its ER rows"):
        convert.device_container("EHYBDevice", cut, static, device="cpu",
                                 host=je)


# ---------------------------------------------------------------------------
# er_col_rows: the global ER table's live prefixes, from the pattern
# ---------------------------------------------------------------------------

def live_counts(je) -> np.ndarray:
    """(Rr,) live entries of each row of the JAX build's global ER table,
    from its pattern (``fill_plan["er_dst"]``)."""
    return np.bincount(je.fill_plan["er_dst"] // je.er_width,
                       minlength=je.er_rows)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_er_col_rows_gives_the_live_counts(name, method):
    """Row r's live count is the number of k with ``er_col_rows[k] > r``,
    on the port's build and counted from the JAX build's pattern; the
    array is non-increasing, (We,) and the same on both containers."""
    _, te, je = builds(name, method)
    d = EHYBDevice.from_ehyb(te, device="cpu")
    ecr = d.er_col_rows
    assert ecr.dtype == torch.int32 and ecr.shape == (te.er_width,)
    assert bool((ecr.diff() <= 0).all())
    np.testing.assert_array_equal(
        ref.er_widths(ecr, te.er_rows).numpy(), live_counts(je))
    pk = EHYBPackedDevice.from_packed(tehyb.pack_staircase(te),
                                      device="cpu")
    assert torch.equal(pk.er_col_rows, ecr)


def test_er_col_rows_keeps_stored_zeros():
    """Explicit zeros keep their entries: the same widths as the matrix
    without them."""
    _, te, je = builds("powerlaw_4k_zeros", "bfs")
    _, te_nz, _ = builds("powerlaw_4k", "bfs")
    d = EHYBDevice.from_ehyb(te, device="cpu")
    assert int((d.er_s_vals == 0).sum()) > 0             # zeros stored
    assert torch.equal(d.er_col_rows,
                       EHYBDevice.from_ehyb(te_nz, device="cpu").er_col_rows)
    np.testing.assert_array_equal(
        ref.er_widths(d.er_col_rows, te.er_rows).numpy(), live_counts(je))


@pytest.mark.parametrize("kind", ["EHYBDevice", "EHYBPackedDevice"])
@pytest.mark.parametrize("name", ["powerlaw_4k", "circuit_4k"])
def test_converted_container_carries_er_col_rows(name, kind):
    _, te, je = builds(name, "bfs")
    jd = JEHYBDevice.from_ehyb(je, jnp.float32)
    if kind == "EHYBPackedDevice":
        from repro.core.spmv import EHYBPackedDevice as JEHYBPackedDevice
        jd = JEHYBPackedDevice.from_packed(jehyb.pack_staircase(je),
                                           jnp.float32)
    leaves, static = jax_leaves(jd)
    got = convert.device_container(kind, leaves, static, device="cpu",
                                   host=je)
    want = EHYBDevice.from_ehyb(te, device="cpu").er_col_rows
    assert got.er_col_rows.dtype == want.dtype
    assert torch.equal(got.er_col_rows, want)
    cut = dict(leaves, er_vals=leaves["er_vals"][:, :-1])
    with pytest.raises(ValueError, match="ER table"):
        convert.device_container(kind, cut, static, device="cpu", host=je)


# ---------------------------------------------------------------------------
# #6's plain version on the live prefixes, against er_pallas and er_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 4, 32])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["powerlaw_4k", "circuit_4k"])
def test_er_live_prefix_matches_er_pallas(name, dt, r):
    """``kernels.er`` on the CPU (``ref.er_live_ref``, the live prefixes
    only) against ``er_pallas`` in interpret mode and ``ref.er_ref`` on the
    padded table, on ER-heavy builds; the tolerance of
    tests/test_torch_reliability.py (fp32 rtol 2e-5, atol 1e-5; bf16
    max|Δ| / max|y| ≤ 1e-2)."""
    _, te, je = builds(name, "bfs")
    jd = JEHYBDevice.from_ehyb(je, getattr(jnp, dt))
    d = convert.device_container("EHYBDevice", *jax_leaves(jd), device="cpu",
                                 host=je)
    x = np.random.default_rng(r).standard_normal((te.n_pad, r))
    tdt = getattr(torch, dt)
    xt = torch.as_tensor(x).to(tdt)
    want = np.asarray(er_pallas(jnp.asarray(x, getattr(jnp, dt)),
                                jd.er_vals, jd.er_cols,
                                interpret=True).astype(jnp.float32))
    got = K.er(xt, d.er_vals, d.er_cols, d.er_col_rows)
    padded = ref.er_ref(xt, d.er_vals, d.er_cols)
    assert got.shape == (te.er_rows, r) and got.dtype == tdt
    if dt == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), padded.numpy(), rtol=2e-5,
                                   atol=1e-5)
    else:
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got.float().numpy() - want).max() / scale <= 1e-2
        assert (got.float() - padded.float()).abs().max().item() / scale \
            <= 1e-2
    # rows past the live count (sublane padding) are 0
    n_live = int(te.fill_plan["n_er_live"])
    assert bool((got[n_live:] == 0).all())


def test_er_live_prefix_ignores_padded_slots():
    """A non-finite x[0] spreads through the padded table's product (its
    padded slots hold column 0) but not through the live read."""
    _, te, _ = builds("powerlaw_4k", "bfs")
    d = EHYBDevice.from_ehyb(te, device="cpu")
    x = torch.ones((te.n_pad, 1))
    x[0] = float("nan")
    cols = d.er_cols.long()
    live = torch.arange(te.er_width)[None, :] < ref.er_widths(
        d.er_col_rows, te.er_rows)[:, None]
    reads_x0 = ((cols == 0) & live).any(dim=1)
    got = K.er(x, d.er_vals, d.er_cols, d.er_col_rows)[:, 0]
    assert bool(torch.isfinite(got[~reads_x0]).all())
    padded = ref.er_ref(x, d.er_vals, d.er_cols)[:, 0]
    assert bool(torch.isnan(padded[~reads_x0]).any())
    with pytest.raises(ValueError, match="er_col_rows"):
        K.er(x, d.er_vals, d.er_cols, d.er_col_rows[:-1])

"""The uniform-tile kernels' live read, on the CPU: the plain versions of
#7 ``ehyb_fused_spmm`` and #9 ``ehyb_ell_spmm`` (``ref.ehyb_fused_stream_ref``
and ``ref.ehyb_ell_ref``), which read each row of the (V, W) tiles only to
its width from ``col_rows``, as the kernels do, and which the wrappers run
for CPU tensors.

They are held against the JAX package's ``ehyb_fused_spmm_pallas`` and
``ehyb_ell_spmm_pallas`` in interpret mode on matrices with ragged row
widths: ``powerlaw_4k`` from the SUITE, a hub row, every fifth row empty,
and a 1×1 matrix; K ∈ {2, 5, 16, 33}; max|Δ| / max|Y_ref| ≤ 1e-5 in fp32
and ≤ 5e-2 in bf16 (the SpMM tolerance of ``tests/test_spmm.py``).  A
non-finite x_new[0] reaches exactly the rows whose CSR product reads it,
through #7, #9 and the K = 1 wrappers #1 and #4, while the padded tiles'
product spreads it further.  The wrappers check ``col_rows``' shape and
dtype on every device.  Inputs come from numpy with a seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ehyb as jehyb
from repro.core import matrices as jmat
from repro.core.spmv import EHYBDevice as JEHYBDevice
from repro.kernels.ehyb_spmm import (ehyb_ell_spmm_pallas,
                                     ehyb_fused_spmm_pallas)
from repro_torch import convert
from repro_torch.kernels import ehyb_spmm as KM
from repro_torch.kernels import ehyb_spmv as K
from repro_torch.kernels import ref

TOL = {"f32": (jnp.float32, torch.float32, 1e-5),
       "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
STATIC = ("n", "n_pad", "n_parts", "vec_size", "has_er")


def _ragged(name: str):
    """A JAX ``SparseCSR`` with ragged row widths."""
    if name == "powerlaw_4k":
        return jmat.SUITE[name]()
    if name == "1x1":
        return jmat.from_coo(1, np.array([0]), np.array([0]), np.array([2.5]))
    rng = np.random.default_rng(5)
    if name == "hub_row":               # row 0 holds every column
        n = 512
        rows = np.concatenate([np.arange(n), np.zeros(n, np.int64),
                               rng.integers(1, n, 2 * n)])
        cols = np.concatenate([np.arange(n), np.arange(n),
                               rng.integers(0, n, 2 * n)])
    else:                               # "empty_rows": every fifth row
        n = 384
        rows = rng.integers(0, n, 6 * n)
        rows = rows[rows % 5 != 0]
        cols = rng.integers(0, n, len(rows))
    return jmat.from_coo(n, rows, cols, rng.standard_normal(len(rows)))


MATS = ("powerlaw_4k", "hub_row", "empty_rows", "1x1")


def _builds(name, jdt):
    """(JAX container, port container on the same tables, host build)."""
    e = jehyb.build_ehyb(_ragged(name), method="bfs")
    jd = JEHYBDevice.from_ehyb(e, jdt)
    names = [f.name for f in dataclasses.fields(jd)
             if not isinstance(getattr(jd, f.name), (int, bool, tuple))]
    td = convert.device_container(
        "EHYBDevice", {k: np.asarray(getattr(jd, k)) for k in names},
        {k: getattr(jd, k) for k in STATIC}, device="cpu", host=e)
    return jd, td, e


def _err(y, y_ref):
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    return np.abs(y - y_ref).max() / (np.abs(y_ref).max() + 1e-30)


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("k", [2, 5, 16, 33])
@pytest.mark.parametrize("name", MATS)
def test_live_plain_spmm_matches_pallas_interpret(name, k, dt):
    jdt, tdt, tol = TOL[dt]
    jd, td, e = _builds(name, jdt)
    if name == "1x1":
        assert (e.n, e.ell_width) == (1, 1)
    else:                       # ragged: some rows end before the tile does
        widths = (torch.arange(td.vec_size)[None, :, None]
                  < td.col_rows[:, None, :]).sum(dim=2)
        assert int(widths.min()) < e.ell_width
    x = np.random.default_rng(k).standard_normal((e.n_pad, k))
    xt = torch.as_tensor(x).to(tdt)
    want = ehyb_fused_spmm_pallas(jnp.asarray(x, jdt), jd.ell_vals,
                                  jd.ell_cols, jd.er_p_vals, jd.er_p_cols,
                                  jd.er_p_rows, interpret=True)
    plain = ref.ehyb_fused_stream_ref(xt, td.ell_vals, td.ell_cols,
                                      td.col_rows, td.er_stream(), td.has_er)
    assert plain.dtype == tdt and plain.shape == (e.n_pad, k)
    assert _err(plain.double(), np.asarray(want, np.float64)) <= tol
    n0 = KM.ehyb_fused_spmm.launches
    got = KM.ehyb_fused_spmm(xt, td.ell_vals, td.ell_cols, td.col_rows,
                             td.er_stream())
    assert KM.ehyb_fused_spmm.launches == n0           # CPU: no kernel
    torch.testing.assert_close(got, ref.ehyb_fused_stream_ref(
        xt, td.ell_vals, td.ell_cols, td.col_rows, td.er_stream()),
        rtol=0, atol=0)
    xp = x.reshape(e.n_parts, e.vec_size, k)
    want = ehyb_ell_spmm_pallas(jnp.asarray(xp, jdt), jd.ell_vals,
                                jd.ell_cols, interpret=True)
    xpt = torch.as_tensor(xp).to(tdt)
    n0 = KM.ehyb_ell_spmm.launches
    got = KM.ehyb_ell_spmm(xpt, td.ell_vals, td.ell_cols, td.col_rows)
    assert KM.ehyb_ell_spmm.launches == n0
    assert got.dtype == tdt and got.shape == xp.shape
    assert _err(got.double(), np.asarray(want, np.float64)) <= tol
    torch.testing.assert_close(got, ref.ehyb_ell_ref(
        xpt, td.ell_vals, td.ell_cols, td.col_rows), rtol=0, atol=0)


def _nan_rows(m, o) -> np.ndarray:
    """(n_pad,) bool: the permuted-space rows whose CSR product reads
    x_new[0] (a stored entry at the column that permutes to 0)."""
    inv = o.inv_perm.numpy()
    col = int(np.flatnonzero(inv == 0)[0])
    rows = np.repeat(np.arange(m.n), np.diff(m.indptr))[m.indices == col]
    out = np.zeros(o.n_pad, dtype=bool)
    out[inv[rows]] = True
    return out


@pytest.mark.parametrize("kernel", ["ehyb_fused_spmm", "ehyb_ell_spmm",
                                    "ehyb_fused", "ehyb_ell"])
def test_live_read_keeps_a_nonfinite_x0_to_its_rows(kernel):
    """A NaN in x_new[0] reaches every row whose CSR product reads it and
    no other row through the live read; the padded tiles' product (padded
    slots hold column 0) spreads it into rows that do not read it."""
    name = "powerlaw_4k"
    _, o, e = _builds(name, jnp.float32)
    k = 1 if kernel in ("ehyb_fused", "ehyb_ell") else 4
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (o.n_pad, k)), dtype=torch.float32)
    x[0] = float("nan")
    reads = _nan_rows(_ragged(name), o)
    xp = x.reshape(o.n_parts, o.vec_size, k)
    tiles = (o.ell_vals, o.ell_cols, o.col_rows)
    if kernel.startswith("ehyb_fused"):
        got = (KM.ehyb_fused_spmm(x, *tiles, o.er_stream())
               if k > 1 else K.ehyb_fused(x[:, 0], *tiles, o.er_stream(),
                                          o.has_er)[:, None])
        padded = ref.ehyb_fused_ref(x, o.ell_vals, o.ell_cols, o.er_p_vals,
                                    o.er_p_cols, o.er_p_rows)
    else:
        # only partition 0 holds x_new[0] in its x-slice
        reads[o.vec_size:] = False
        got = (KM.ehyb_ell_spmm(xp, *tiles) if k > 1
               else K.ehyb_ell(xp[..., 0], *tiles)[..., None])
        got = got.reshape(o.n_pad, k)
        padded = ref.ehyb_fused_ref(x, o.ell_vals, o.ell_cols, o.er_p_vals,
                                    o.er_p_cols, o.er_p_rows, has_er=False)
    assert reads.any() and not reads.all()
    assert bool(torch.isnan(got[torch.as_tensor(reads)]).all())
    assert bool(torch.isfinite(got[torch.as_tensor(~reads)]).all())
    assert bool(torch.isnan(padded[torch.as_tensor(~reads)]).any())


@pytest.mark.parametrize("bad", ["shape", "dtype"])
@pytest.mark.parametrize("kernel", ["ehyb_fused_spmm", "ehyb_ell_spmm",
                                    "ehyb_fused", "ehyb_ell"])
def test_uniform_wrappers_check_col_rows(kernel, bad):
    _, o, e = _builds("empty_rows", jnp.float32)
    col_rows = (o.col_rows[:, :-1] if bad == "shape"
                else o.col_rows.to(torch.int64))
    k = 1 if kernel in ("ehyb_fused", "ehyb_ell") else 3
    x = torch.zeros((o.n_pad, k))
    xp = x.reshape(o.n_parts, o.vec_size, k)
    calls = {
        "ehyb_fused_spmm": lambda cr: KM.ehyb_fused_spmm(
            x, o.ell_vals, o.ell_cols, cr, o.er_stream()),
        "ehyb_ell_spmm": lambda cr: KM.ehyb_ell_spmm(
            xp, o.ell_vals, o.ell_cols, cr),
        "ehyb_fused": lambda cr: K.ehyb_fused(
            x[:, 0], o.ell_vals, o.ell_cols, cr, o.er_stream(), o.has_er),
        "ehyb_ell": lambda cr: K.ehyb_ell(xp[..., 0], o.ell_vals,
                                          o.ell_cols, cr)}
    assert calls[kernel](o.col_rows).shape[0] in (o.n_pad, o.n_parts)
    with pytest.raises(ValueError if bad == "shape" else TypeError,
                       match="col_rows"):
        calls[kernel](col_rows)

"""The port's plain SpMV paths and CG step against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's containers are carried into the port through
``repro_torch.convert``, so both compute on identical tables.  Where the JAX
function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it on the CPU.  The packed Pallas kernel cannot run
on the installed jax (``pl.load`` is gone), so the packed path is held
against ``repro.core.spmv.ehyb_spmv_permuted`` on the same build.
Tolerances are those of ``tests/test_spmv_conformance.py``:
max|Δ| / max(max|y_ref|, 1) ≤ 1e-4 in fp32 and 1e-1 in bf16.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ehyb as jehyb
from repro.core import matrices as jmat
from repro.core.spmv import EHYBDevice as JEHYBDevice
from repro.core.spmv import EHYBPackedDevice as JEHYBPackedDevice
from repro.core.spmv import ehyb_spmv_permuted as jax_ehyb_spmv_permuted
from repro.kernels.ehyb_spmv import ehyb_fused_pallas
from repro.kernels.solver_step import fused_cg_update as jax_cg_update
from repro_torch import convert
from repro_torch.core.spmv import ehyb_spmv, ehyb_spmv_permuted
from repro_torch.kernels import ehyb_spmv as K
from repro_torch.kernels import ops, ref

TOL = {"f32": (jnp.float32, torch.float32, 1e-4),
       "bf16": (jnp.bfloat16, torch.bfloat16, 1e-1)}


def rel(y, y_ref):
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    return np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1.0)


STATIC = ("n", "n_pad", "n_parts", "vec_size", "has_er")


def jax_build(name):
    m = jmat.SUITE[name]()
    e = jehyb.build_ehyb(m, method="bfs")
    return m, e


def to_port(obj, kind):
    """The JAX container's leaves as numpy arrays + its static fields, through
    ``repro_torch.convert``."""
    lv, _ = obj.tree_flatten()
    names = [f.name for f in dataclasses.fields(obj)
             if not isinstance(getattr(obj, f.name), (int, bool, tuple))]
    assert len(names) == len(lv)
    return convert.device_container(
        kind, {k: np.asarray(getattr(obj, k)) for k in names},
        {k: getattr(obj, k) for k in STATIC}, device="cpu")


def x_for(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("name", ["poisson27_12", "elasticity_8",
                                  "unstruct_4k"])
def test_plain_fused_matches_pallas_interpret(name, dt):
    jdt, tdt, tol = TOL[dt]
    _, e = jax_build(name)
    jd = JEHYBDevice.from_ehyb(e, jdt)
    td = to_port(jd, "EHYBDevice")
    x_new = x_for(e.n_pad)
    want = ehyb_fused_pallas(jnp.asarray(x_new, jdt)[:, None], jd.ell_vals,
                             jd.ell_cols, jd.er_p_vals, jd.er_p_cols,
                             jd.er_p_rows, interpret=True)[:, 0]
    xt = torch.as_tensor(x_new).to(tdt)
    n0 = K.ehyb_fused.launches
    got = ops.ehyb_spmv_fused_permuted(td, xt)       # CPU -> plain version
    assert K.ehyb_fused.launches == n0               # no kernel launched
    assert got.dtype == tdt
    assert rel(got.float(), np.asarray(want, np.float32)) <= tol
    assert rel(ehyb_spmv_permuted(td, xt).float(),
               np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("name", ["poisson3d_16", "elasticity_8",
                                  "powerlaw_4k", "rmat_4k", "circuit_4k"])
def test_plain_packed_matches_ehyb_spmv_permuted(name, dt):
    jdt, tdt, tol = TOL[dt]
    m, e = jax_build(name)
    jp = JEHYBPackedDevice.from_packed(jehyb.pack_staircase(e), jdt)
    tp = to_port(jp, "EHYBPackedDevice")
    x_new = x_for(e.n_pad, 1)
    want = jax_ehyb_spmv_permuted(JEHYBDevice.from_ehyb(e, jdt),
                                    jnp.asarray(x_new, jdt))
    got = ops.ehyb_spmv_packed_permuted(tp, torch.as_tensor(x_new).to(tdt))
    assert got.dtype == tdt and got.shape == (e.n_pad,)
    assert rel(got.float(), np.asarray(want, np.float32)) <= tol
    # original space, against the host CSR in float64
    x = x_for(m.n, 2)
    y = ops.ehyb_spmv_packed(tp, torch.as_tensor(x).to(tdt))
    assert rel(y.float(), m.spmv(x)) <= tol


def test_uniform_original_space_matches_csr():
    m, e = jax_build("powerlaw_4k")
    td = to_port(JEHYBDevice.from_ehyb(e), "EHYBDevice")
    x = x_for(m.n, 3)
    for fn in (ehyb_spmv, ops.ehyb_spmv_fused):
        y = fn(td, torch.as_tensor(x, dtype=torch.float32))
        assert y.shape == (m.n,) and rel(y, m.spmv(x)) <= 1e-4
    x2 = np.stack([x, -x], axis=1)
    y2 = ehyb_spmv(td, torch.as_tensor(x2, dtype=torch.float32))
    assert y2.shape == (m.n, 2) and rel(y2[:, 1], -m.spmv(x)) <= 1e-4


def test_packed_unpacks_to_the_uniform_tiles():
    _, e = jax_build("elasticity_8")
    pk = jehyb.pack_staircase(e)
    vals, cols = ref.unpack_staircase(
        torch.as_tensor(pk.packed_vals), torch.as_tensor(pk.packed_cols),
        torch.as_tensor(pk.col_starts), torch.as_tensor(pk.col_rows),
        e.vec_size)
    np.testing.assert_array_equal(vals.numpy(), e.ell_vals)
    np.testing.assert_array_equal(cols.numpy(), e.ell_cols.astype(np.int64))


@pytest.mark.parametrize("n", [1000, 4096 + 3])
def test_cg_update_ref_matches_pallas_interpret(n):
    rng = np.random.default_rng(n)
    vecs = [rng.standard_normal(n).astype(np.float32) for _ in range(5)]
    alpha = np.float32(0.37)
    want = jax_cg_update(*(jnp.asarray(v) for v in vecs), jnp.asarray(alpha),
                         interpret=True)
    got = ref.cg_update_ref(*(torch.as_tensor(v) for v in vecs),
                            torch.tensor(alpha))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    for g, w in zip(got[3:], want[3:]):
        assert abs(float(g) - float(w)) <= 1e-6 * abs(float(w))


def test_convert_keeps_bf16_bits_and_csr():
    a = jnp.asarray(np.random.default_rng(4).standard_normal(64),
                    jnp.bfloat16)
    t = convert.tensor_from_numpy(np.asarray(a), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.uint16).numpy(),
                                  np.asarray(a).view(np.uint16))
    m = jmat.SUITE["poisson3d_16"]()
    c = convert.csr_from_arrays(m.n, m.indptr, m.indices, m.data)
    x = x_for(m.n)
    np.testing.assert_array_equal(c.spmv(x), m.spmv(x))

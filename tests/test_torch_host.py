"""The port's host format layer is bit-identical to the JAX package's.

For every SUITE matrix, under the ``natural`` and ``bfs`` strategies at a
pinned ``n_parts``/``vec_size``, the arrays of ``build_ehyb``,
``group_er_by_partition`` and ``pack_staircase`` — values and dtypes — equal
``repro.core``'s.  The generators, the other two strategies and the cache
sizing are held the same way.
"""

import numpy as np
import pytest

from repro.core import ehyb as jehyb
from repro.core import matrices as jmat
from repro.core import partition as jpart
from repro_torch.core import ehyb as tehyb
from repro_torch.core import matrices as tmat
from repro_torch.core import partition as tpart

EHYB_ARRAYS = ("ell_vals", "ell_cols", "part_widths", "slice_widths",
               "er_vals", "er_cols", "er_row_idx", "perm", "inv_perm")
EHYB_SCALARS = ("n", "n_pad", "n_parts", "vec_size", "ell_width", "er_rows",
                "er_width", "nnz", "nnz_in", "partition_method")


def assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def suite():
    return {k: (tmat.SUITE[k](), jmat.SUITE[k]()) for k in tmat.SUITE}


def test_suite_generators_match(suite):
    assert list(tmat.SUITE) == list(jmat.SUITE)
    for name, (t, j) in suite.items():
        assert t.n == j.n, name
        for f in ("indptr", "indices", "data"):
            assert_same(getattr(t, f), getattr(j, f), f"{name}.{f}")


@pytest.mark.parametrize("method", ["natural", "bfs"])
@pytest.mark.parametrize("name", list(tmat.SUITE))
def test_ehyb_build_group_pack_bit_identical(suite, name, method):
    t_m, j_m = suite[name]
    n_parts, vec_size = jpart.choose_vec_size(j_m.n)
    kw = dict(method=method, n_parts=n_parts, vec_size=vec_size)
    te = tehyb.build_ehyb(t_m, part=tpart.make_partition(t_m, **kw))
    je = jehyb.build_ehyb(j_m, part=jpart.make_partition(j_m, **kw))
    for f in EHYB_SCALARS:
        assert getattr(te, f) == getattr(je, f), (name, f)
    for f in EHYB_ARRAYS:
        assert_same(getattr(te, f), getattr(je, f), f"{name}.{f}")
    for f, v in je.fill_plan.items():
        assert_same(te.fill_plan[f], v, f"{name}.fill_plan.{f}")
    tg, jg = tehyb.group_er_by_partition(te), jehyb.group_er_by_partition(je)
    assert tg.keys() == jg.keys()
    for f, v in jg.items():
        assert_same(tg[f], v, f"{name}.group.{f}")
    tp, jp = tehyb.pack_staircase(te), jehyb.pack_staircase(je)
    assert tp.packed_len == jp.packed_len
    for f in ("packed_vals", "packed_cols", "col_starts", "col_rows"):
        assert_same(getattr(tp, f), getattr(jp, f), f"{name}.{f}")
    for f, v in jp.pack_plan.items():
        assert_same(tp.pack_plan[f], v, f"{name}.pack_plan.{f}")
    for vb in (2, 4):
        jb = jp.bytes_moved(val_bytes=vb)
        tb = tp.bytes_moved(val_bytes=vb)
        assert tb == {k: v for k, v in jb.items() if k != "interconnect"}


@pytest.mark.parametrize("method", ["mincut", "hub"])
@pytest.mark.parametrize("name", ["unstruct_4k", "powerlaw_4k", "circuit_4k"])
def test_other_strategies_partition_identically(suite, name, method):
    t_m, j_m = suite[name]
    n_parts, vec_size = jpart.choose_vec_size(j_m.n)
    tp = tpart.make_partition(t_m, method, n_parts=n_parts, vec_size=vec_size)
    jp = jpart.make_partition(j_m, method, n_parts=n_parts, vec_size=vec_size)
    for f in ("part_vec", "perm", "inv_perm"):
        assert_same(getattr(tp, f), getattr(jp, f), f"{name}.{method}.{f}")


@pytest.mark.parametrize("n", [1, 648, 4096, 98_304, 786_432])
def test_reference_sizing_matches(n):
    assert tpart.choose_vec_size(n) == jpart.choose_vec_size(n)
    assert tpart.choose_vec_size(n, 2) == jpart.choose_vec_size(n, 2)


def test_cuda_sizing_on_h100_constants():
    """Eq. 1–2 with an H100's opt-in shared memory per block (232,448 B)
    and SM count (132), 32-row alignment, fp32 x-slice + fp32 y tile."""
    assert tpart.choose_vec_size_cuda(786_432, 4, 232_448, 132) == (132, 5984)
    n_parts, vec = tpart.choose_vec_size_cuda(10_000_000, 4, 232_448, 132)
    assert n_parts % 132 == 0 and vec % 32 == 0
    assert vec * 8 < 232_448 and vec < 1 << 16 and n_parts * vec >= 10_000_000

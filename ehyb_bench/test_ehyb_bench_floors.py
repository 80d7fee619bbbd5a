"""The floors' arithmetic against the numbers worked out by hand."""

import pytest

from ehyb_bench import floors

HPCG = (2_097_152, 55_742_968)
ELAST = (786_432, 61_731_000)


@pytest.mark.parametrize("shape, k, nbytes, micros", [
    (HPCG, 1, 239_749_088, 71.6),
    (ELAST, 1, 253_215_456, 75.6),
    (ELAST, 16, 347_587_296, 103.8),
])
def test_apply_floor(shape, k, nbytes, micros):
    n, nnz = shape
    assert floors.apply_bytes(n, nnz, k, 4) == nbytes
    assert floors.apply_floor_s(n, nnz, k, 4) * 1e6 == pytest.approx(
        micros, abs=0.05)


def test_cg_iteration_floor():
    n, nnz = HPCG
    assert floors.cg_iter_bytes(n, nnz, 4) == 306_857_952
    assert floors.cg_iter_floor_s(n, nnz, 4) * 1e6 == pytest.approx(
        91.6, abs=0.05)


def test_bytes_bound_every_cell_and_no_index_bytes():
    n, nnz = ELAST
    flops_s = 2 * nnz * 16 / floors.FP32_PEAK
    assert flops_s * 1e6 == pytest.approx(29.5, abs=0.05)
    assert floors.apply_floor_s(n, nnz, 16, 4) > flops_s
    # values and vectors only: halving the value size halves that term
    assert floors.apply_bytes(n, nnz, 1, 2) * 2 == \
        floors.apply_bytes(n, nnz, 1, 4)

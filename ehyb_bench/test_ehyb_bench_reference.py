"""The plain reference product and its bfloat16 control at a tiny size."""

import numpy as np
import pytest
import torch

from ehyb_bench.matrices import q1_elasticity
from ehyb_bench.reference.control import ControlOperator
from ehyb_bench.reference.rows import PaddedRows

from ehyb_bench.test_ehyb_bench_matrices import dense


@pytest.fixture(scope="module")
def matrix():
    return q1_elasticity.generate({"ne": 3, "E": 1.0, "nu": 0.25}, "cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_reference_matches_a_dense_product(matrix, k):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((matrix.n, k) if k > 1 else (matrix.n,), generator=g,
                    dtype=torch.float64)
    want = dense(matrix) @ x.numpy()
    got = PaddedRows(matrix, "cpu").matmul(x).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_reference_blocks_cover_every_row(matrix, monkeypatch):
    from ehyb_bench.reference import rows

    monkeypatch.setattr(rows, "_BLOCK_ELEMS", 7 * 81)
    x = torch.randn(matrix.n, dtype=torch.float64)
    got = rows.PaddedRows(matrix, "cpu").matmul(x).numpy()
    want = dense(matrix) @ x.numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_control_is_a_bfloat16_product(matrix):
    x = torch.randn(matrix.n, dtype=torch.float32)
    ref = PaddedRows(matrix, "cpu").matmul(x)
    err = float((ControlOperator(matrix, "cpu") @ x).double()
                .sub(ref).abs().max() / ref.abs().max())
    assert 1e-4 < err < 5e-2

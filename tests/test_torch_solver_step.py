"""The fused CG step of the port on the CPU: the launch grid of its CUDA
kernel (``kernels/solver_step.py::launch_grid``) and the solver's handling of
a non-finite step, against the JAX package's ``cg`` with its Pallas CG-step
kernel in interpret mode.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here the grid it is launched with is held to cover every element exactly
once under the kernel's walk, for the constants in ``csrc/solver_step.cu``
and for others."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import cg as jax_cg
from repro_torch.core.solver import cg
from repro_torch.kernels import build
from repro_torch.kernels import solver_step as S

UNIT = 8                      # elements a unit of the kernel


def source_geometry() -> tuple[int, int, int]:
    """(threads a block, elements a thread per chunk, blocks an SM) as
    ``csrc/solver_step.cu`` fixes them (what ``cg_update_geometry``
    returns on the card)."""
    src = (build.CSRC / "solver_step.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    return const("kThreads"), const("kUnits") * UNIT, const("kBlocksPerSm")


def kernel_walk(n: int, grid: int, geometry, vec: int) -> np.ndarray:
    """Every element index the kernel's threads compute, as
    ``cg_update_kernel`` walks them: block b takes chunks b, b + grid, ...
    while chunk · threads · elems < n; in a chunk, thread t takes the
    vectors j · threads + t (j < elems / vec) of ``vec`` elements each (a
    16-byte load: 4 fp32, 8 bf16), stopping at n."""
    threads, elems, _ = geometry
    chunk = threads * elems
    chunks = -(-n // chunk)
    steps = max(1, -(-chunks // grid))
    c = np.arange(grid)[:, None] + grid * np.arange(steps)[None, :]
    vectors = (np.arange(elems // vec)[:, None] * threads
               + np.arange(threads)[None, :])                 # (J, T)
    e = (c[:, None, :, None, None] * chunk
         + vectors.T[None, :, None, :, None] * vec
         + np.arange(vec)[None, None, None, None, :])
    return e[e < n]


GEOMETRIES = [source_geometry(), (32, 8, 1), (64, 16, 2), (128, 32, 4)]


def test_source_geometry_sizes_the_solve():
    threads, elems, blocks_per_sm = source_geometry()
    assert threads % 32 == 0 and threads <= 1024
    assert elems % UNIT == 0 and blocks_per_sm >= 1
    # elasticity3d(64)'s permuted vectors on an H100 (132 × 5,984 rows)
    grid = S.launch_grid(789_888, 132, source_geometry())
    assert grid == min(-(-789_888 // (threads * elems)), 132 * blocks_per_sm)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_launch_grid_is_a_function_of_n_and_the_sm_count(geometry):
    threads, elems, blocks_per_sm = geometry
    chunk = threads * elems
    for sms in (1, 2, 7, 132):
        for n in (0, 1, 7, chunk - 1, chunk, chunk + 1, 10 ** 6, 2 ** 31 - 1):
            grid = S.launch_grid(n, sms, geometry)
            assert grid == S.launch_grid(n, sms, tuple(geometry))
            assert 1 <= grid <= max(1, blocks_per_sm * sms)
            assert grid == max(1, min(-(-n // chunk), blocks_per_sm * sms))


@pytest.mark.parametrize("vec", [4, 8])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_launch_grid_covers_every_element_once(geometry, sms, vec):
    """n from 1 to three blocks' chunks, fp32 (4 elements a 16-byte load)
    and bf16 (8): the kernel's walk over the grid computes each element
    exactly once (with sms = 1 the grid is capped and blocks walk several
    chunks)."""
    threads, elems, _ = geometry
    for n in range(1, 3 * threads * elems + 1):
        e = np.sort(kernel_walk(n, S.launch_grid(n, sms, geometry),
                                geometry, vec))
        assert e.shape == (n,) and (e == np.arange(n)).all(), n


def test_cg_nan_ap_diverges_and_rolls_back_like_jax():
    """The fused update (the plain version on the CPU; JAX's Pallas kernel
    in interpret mode): a matvec whose output turns NaN in its last element
    once its input is non-zero there.  The warm start x0 is zero there, so
    r0 is finite; the first step's ap is NaN, so is rr, and both solvers
    roll the step back and stop "diverged" with x = x0."""
    rng = np.random.default_rng(21)
    q = rng.standard_normal((16, 16))
    a = q @ q.T + 16 * np.eye(16)
    b = rng.standard_normal(16)
    x0 = rng.standard_normal(16)
    x0[-1] = 0.0
    inv = 1.0 / np.diag(a)
    last = np.arange(16) == 15
    a32 = jnp.asarray(a, jnp.float32)
    at = torch.as_tensor(a, dtype=torch.float32)

    def mv_j(v):
        return a32 @ v + jnp.where(last & (v[-1] != 0), jnp.nan, 0.0)

    def mv_t(v):
        nan = torch.as_tensor(last) & (v[-1] != 0)
        return at @ v + torch.where(nan, float("nan"), 0.0)

    kw = dict(tol=1e-6, max_iters=20, fused_update=True)
    rj = jax_cg(mv_j, jnp.asarray(b, jnp.float32), precond_inv=jnp.asarray(
        inv, jnp.float32), x0=jnp.asarray(x0, jnp.float32), **kw)
    n0 = S.fused_cg_update.launches
    r = cg(mv_t, torch.as_tensor(b, dtype=torch.float32),
           precond_inv=torch.as_tensor(inv, dtype=torch.float32),
           x0=torch.as_tensor(x0, dtype=torch.float32), **kw)
    assert S.fused_cg_update.launches == n0          # plain on the CPU
    assert r.status == rj.status == "diverged"
    assert int(r.iters) == int(rj.iters) == 0
    x0_32 = x0.astype(np.float32)
    np.testing.assert_array_equal(r.x.numpy(), x0_32)
    np.testing.assert_array_equal(np.asarray(rj.x), x0_32)
    assert np.isfinite(float(r.residual))
    np.testing.assert_allclose(float(r.residual), float(rj.residual),
                               rtol=1e-5)

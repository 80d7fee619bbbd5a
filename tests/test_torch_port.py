"""Port-only tests of ``repro_torch``: device rules, planning limits, bind
validation, spaces and import hygiene.  No JAX here."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import ExecutionConfig, PlanCache, Space, plan
from repro_torch.core import counters
from repro_torch.core.matrices import SUITE, from_coo, poisson3d
from repro_torch.kernels import solver_step

SRC = Path(__file__).resolve().parents[1] / "src"
PINNED = ExecutionConfig(format="ehyb_packed", partition_method="bfs")


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = poisson3d(6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan(m, execution=PINNED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan(m, execution=PINNED, device="cuda:0")
    assert plan(m, execution=PINNED, device="cpu").device.type == "cpu"


def test_converters_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from repro_torch import convert
    from repro_torch.core.ehyb import build_ehyb
    from repro_torch.core.spmv import EHYBDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tensor_from_numpy(np.ones(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.device_container("EHYBDevice", {}, {})
    assert convert.tensor_from_numpy(np.ones(4), "cpu").device.type == "cpu"
    e = build_ehyb(poisson3d(4), n_parts=2, vec_size=32)
    with pytest.raises(TypeError):
        EHYBDevice.from_ehyb(e)                      # no silent CPU default
    assert EHYBDevice.from_ehyb(e, device="cpu").ell_vals.device.type == "cpu"


def test_unported_planning_choices_raise():
    """The default plan (format and partition autotuned) and every format
    plan; what is not ported (the ``dist`` workload) raises, as do
    unknown names."""
    m = poisson3d(6)
    p = plan(m, device="cpu")                        # format="auto"
    assert p.tuning is not None and p.format == p.tuning.format
    assert p.partition_tuning is not None
    p = plan(m, execution=ExecutionConfig(format="ehyb"), device="cpu")
    assert p.partition_strategy == p.partition_tuning.strategy
    p = plan(m, execution=ExecutionConfig(format="csr",
                                          partition_method="bfs"),
             device="cpu")
    assert p.format == "csr" and p.partition_strategy == "bfs"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plan(m, execution=ExecutionConfig(workload="dist"), device="cpu")
    with pytest.raises(KeyError):
        plan(m, execution=ExecutionConfig(format="coo"), device="cpu")
    with pytest.raises(ValueError):
        plan(m, execution=PINNED, device="meta")
    op = plan(m, execution=PINNED, device="cpu").bind(m)
    with pytest.raises(ValueError, match="bicgstab"):   # the roster
        op.solve(np.ones(m.n), method="gmres")
    r = op.solve(np.ones(m.n), method="bicgstab")
    assert r.status == "converged"
    with pytest.raises(ValueError, match="fused"):
        op.solve(np.ones(m.n), method="bicgstab", fused_update=True)


def test_bind_validates_values_and_pattern():
    m = poisson3d(6)
    p = plan(m, execution=PINNED, device="cpu")
    bad = m.data.copy()
    bad[3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        p.bind(bad)
    with pytest.raises(ValueError, match="per-nnz"):
        p.bind(m.data[:-1])
    with pytest.raises(ValueError, match="pattern"):
        p.bind(poisson3d(5))
    assert p.bind(bad, validate=False).nnz == m.nnz


def test_plan_cache_shares_partition_and_host_build():
    m = SUITE["elasticity_8"]()
    cache = PlanCache()
    p1 = plan(m, execution=PINNED, device="cpu", cache=cache)
    assert plan(m, execution=PINNED, device="cpu", cache=cache) is p1
    counters.reset()
    p2 = plan(m, execution=ExecutionConfig(format="ehyb",
                                           partition_method="bfs"),
              device="cpu", cache=cache)
    assert p2.partition is p1.partition
    p1.bind(m)
    p2.bind(m)
    p2.bind(m.data * 1.0)          # same values: no second build
    snap = counters.snapshot()
    assert snap.get("partition", 0) == 0 and snap["build_ehyb"] == 1
    p2.bind(m.data * 2.0)          # new values: scattered into p2's tables
    snap = counters.snapshot()
    assert snap.get("partition", 0) == 0 and snap["build_ehyb"] == 1
    assert snap.get("ehyb_refill", 0) == 0


def test_spaces_round_trip_and_dtypes():
    rows = np.repeat(np.arange(0, 128, 2), 4)
    cols = np.random.default_rng(0).integers(0, 128, len(rows))
    m = from_coo(128, rows, cols.astype(np.int32),
                 np.random.default_rng(1).standard_normal(len(rows)))
    for fmt in ("ehyb", "ehyb_packed"):
        op = plan(m, execution=ExecutionConfig(format=fmt,
                                               partition_method="bfs"),
                  device="cpu").bind(m)
        x = np.random.default_rng(2).standard_normal(m.n)
        xn = op.to_space(x)
        assert xn.shape == (op.n_pad,) and op.supports_permuted
        np.testing.assert_array_equal(op.from_space(xn).numpy(),
                                      x.astype(np.float32))
        y = op @ x
        assert y.dtype == torch.float32 and y.shape == (m.n,)
        np.testing.assert_allclose(y.numpy(), m.spmv(x), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(
            op.apply(xn, space=Space.PERMUTED).numpy(),
            op.to_space(y).numpy(), rtol=1e-6, atol=1e-6)
        op64 = op.plan.bind(m, dtype=torch.float64)
        np.testing.assert_allclose((op64 @ x).numpy(), m.spmv(x),
                                   rtol=1e-12, atol=1e-12)


def test_cpu_solve_masks_iterations_past_the_stop():
    """The host reads the stop condition every 8 iterations; the masked
    iterations in between leave x, iters and status as they were."""
    m = SUITE["elasticity_8"]()
    op = plan(m, execution=PINNED, device="cpu").bind(m)
    b = np.random.default_rng(1).standard_normal(m.n)
    n0 = solver_step.fused_cg_update.launches
    r = op.solve(b, precond="spai", fused_update=True)   # plain on the CPU
    assert solver_step.fused_cg_update.launches == n0
    assert r.status == "converged" and int(r.iters) == 6
    x = r.x.double().numpy()
    assert np.linalg.norm(m.spmv(x) - b) / np.linalg.norm(b) <= 1e-5
    r0 = op.solve(b, precond="spai", x0=r.x)             # warm start
    assert r0.status == "converged" and int(r0.iters) < int(r.iters)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "n = sum(k.startswith('repro_torch.') for k in sys.modules)\n"
        "print(n, bad)\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 16, out.stdout

"""``y = op @ x`` in the original space, dispatched back to back from a
pool of seeded inputs (x of shape (n,) for one right-hand side, (n, K)
for K), with one synchronise at the end of the window.  The answers
judged are the window's last output of every pool entry and the outputs
of a few dispatches drawn from the seed, each against the float64
reference product: the worst max|y - y_ref| / max|y_ref|."""

from __future__ import annotations

import time

import numpy as np
import torch


def make_inputs(traffic: dict, n: int, dtype, seed: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    k = traffic["rhs"]
    shape = (traffic["pool"], n) if k == 1 else (traffic["pool"], n, k)
    pool = torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32).to(dtype)
    rng = np.random.default_rng(seed)
    early = rng.choice(traffic["early_span"], traffic["early_samples"],
                       replace=False)
    return {"pool": pool, "early": set(int(i) for i in early)}


def warm(op, inputs: dict, traffic: dict, sync) -> None:
    for _ in range(2):
        for x in inputs["pool"]:
            op @ x
    sync()


def window(op, inputs: dict, traffic: dict, seconds: float, sync) -> dict:
    pool, early = inputs["pool"], inputs["early"]
    size = len(pool)
    last = [None] * size
    kept = {}
    i = 0
    sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        j = i % size
        y = op @ pool[j]
        last[j] = y
        if i in early:
            kept[i] = (j, y)
        i += 1
    sync()
    elapsed = time.perf_counter() - t0
    answers = [(j, y) for j, y in enumerate(last) if y is not None]
    answers += list(kept.values())
    return {"attempted": i, "failed": 0, "elapsed_s": elapsed,
            "answers": answers,
            "e2e": {"spmv_gflops": 2 * op.nnz * traffic["rhs"] * i
                    / elapsed / 1e9}}


def profiled_work(op, inputs: dict, traffic: dict, sync) -> dict:
    """What the traced run profiles: ``traffic["profile_applies"]``
    dispatches, as the window runs them, and one synchronise."""
    pool = inputs["pool"]
    for i in range(traffic["profile_applies"]):
        op @ pool[i % len(pool)]
    sync()
    return {"applies": traffic["profile_applies"]}


def control_answers(ctrl, inputs: dict, traffic: dict) -> list:
    """The control's product of every pool entry once."""
    return [(j, ctrl @ x) for j, x in enumerate(inputs["pool"])]


def check(ref, inputs: dict, answers: list) -> dict:
    worst = 0.0
    for j, y in answers:
        y_ref = ref.matmul(inputs["pool"][j])
        err = (y.to(y_ref.device).double() - y_ref).abs().max()
        worst = max(worst, float(err / y_ref.abs().max()))
    return {"rel_err": worst}

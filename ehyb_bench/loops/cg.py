"""Closed loop of solves: one ``op.solve(b)`` after another, each ending in
a host read of its solution into a host buffer made before the window
(pinned where the pool is on a card), so the read allocates nothing.  The
right-hand sides are a pool drawn from the seed on the device before the
window; solve i takes pool entry ``order[i mod pool]``.  A solve that does
not converge is a failed operation.  The answers judged are the window's
last solution of every pool entry and the solutions of a few solves drawn
from the seed, each by its true residual ‖b - A x‖ / ‖b‖ in float64."""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch


def make_inputs(traffic: dict, n: int, dtype, seed: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pool = torch.randn((traffic["pool"], n), generator=g, device=device,
                       dtype=torch.float32).to(dtype)
    order = torch.randperm(traffic["pool"], generator=g,
                           device=device).tolist()
    early = np.random.default_rng(seed).choice(
        traffic["early_span"], traffic["early_samples"], replace=False)
    pin = pool.is_cuda

    def buffers(count):
        return [torch.empty(n, dtype=dtype, pin_memory=pin)
                for _ in range(count)]
    return {"pool": pool, "order": order,
            "early": dict(zip(early.tolist(), buffers(len(early)))),
            "last": buffers(traffic["pool"])}


def _solve_to_host(op, b, traffic: dict, out: torch.Tensor):
    res = op.solve(b, method=traffic["method"], precond=traffic["precond"],
                   tol=traffic["tol"], max_iters=traffic["max_iters"],
                   warn=False)
    out.copy_(res.x)
    return int(res.iters), bool(res.converged)


def warm(op, inputs: dict, traffic: dict, sync) -> None:
    j = inputs["order"][0]
    _solve_to_host(op, inputs["pool"][j], traffic, inputs["last"][j])


def window(op, inputs: dict, traffic: dict, seconds: float, sync) -> dict:
    pool, order = inputs["pool"], inputs["order"]
    early, last = inputs["early"], inputs["last"]
    latencies, iters, kept = [], [], []
    failed = 0
    sync()
    t0 = time.perf_counter()
    while True:
        i = len(latencies)
        j = order[i % len(order)]
        out = early.get(i, last[j])
        t = time.perf_counter()
        it, converged = _solve_to_host(op, pool[j], traffic, out)
        t_done = time.perf_counter()
        latencies.append(t_done - t)
        iters.append(it)
        failed += not converged
        if i in early:
            kept.append((j, out))
        if t_done - t0 >= seconds:
            break
    elapsed = t_done - t0
    count = len(latencies)
    answers = kept + [(j, last[j]) for j in set(order[:count])]
    p95 = statistics.quantiles(latencies, n=20, method="inclusive")[18] \
        if count > 1 else latencies[0]
    return {"attempted": count, "failed": failed, "elapsed_s": elapsed,
            "latencies_s": latencies, "iters": iters, "answers": answers,
            "e2e": {"cg_solve_p95_ms": p95 * 1e3}}


def profiled_work(op, inputs: dict, traffic: dict, sync) -> dict:
    """What the traced run profiles: two solves, as the window runs them."""
    iters = 0
    for j in inputs["order"][:2]:
        iters += _solve_to_host(op, inputs["pool"][j], traffic,
                                inputs["last"][j])[0]
    return {"iters": iters}


def control_answers(ctrl, inputs: dict, traffic: dict) -> list:
    """The control's solve of every pool entry once."""
    for j, out in enumerate(inputs["last"]):
        _solve_to_host(ctrl, inputs["pool"][j], traffic, out)
    return list(enumerate(inputs["last"]))


def check(ref, inputs: dict, answers: list) -> dict:
    worst = 0.0
    for j, x in answers:
        b = inputs["pool"][j].double()
        r = b - ref.matmul(x.to(b.device).double())
        worst = max(worst, float(r.norm() / b.norm()))
    return {"rel_residual": worst}

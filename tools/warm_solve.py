#!/usr/bin/env python3
"""Warm-solve wall time of two trees of the port, interleaved, on one card.

    python3 tools/warm_solve.py --pairs PARENT,CHANGE [--rounds 1] [--reps 15]
    python3 tools/warm_solve.py --src TREE [--reps 15] [--train]

Each ``--pairs`` round runs one process per tree in the order PARENT,
CHANGE, CHANGE, PARENT, so that a drift of the card or the host over the
call falls on both; ``TREE`` is a directory holding ``src/repro_torch``
(for example an unpacked ``git archive`` of a commit).  Each process
builds ``elasticity3d(64)`` (786,432 rows, 61.7M nnz) on an
``ehyb_packed`` bfs plan, binds it in fp32 and solves ``A x = b`` (CG,
diagonal SPAI, tol 1e-6, b seeded as in ``chip_smoke.py``) once, then
times ``--reps`` warm solves (host clock, ending in
``torch.cuda.synchronize()``) in up to three states of the process:

* ``alone`` — nothing else bound;
* ``layer`` — with the pruned llama3_2_1b FFN down projection of
  ``chip_smoke.py`` phase 8 bound and kept alive (W 2048 × 8192,
  normal(0, 0.02), density 0.1, k = 16) after one forward of 16 tokens
  under ``torch.no_grad()``;
* ``trained`` (``--train``, the trees whose layer has ``update_values``;
  ``--pairs`` passes it to CHANGE only) — after three training steps of
  that layer (forward, MSE, backward with Aᵀ ḡ on the transpose plan,
  ``update_values``), as ``chip_smoke.py`` phase 11d takes them.

Each process prints one JSON line: the tree, the iterations, and for each
state the warm times in ms with their median, minimum and maximum.  The
driver then prints one summary line a state and tree: the medians of its
runs.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

NX = 64
SEED = 0
D_MODEL, D_FF, TOKENS = 2048, 8192, 16


def _warm_ms(op, b, reps: int) -> list:
    import torch

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        op.solve(b, precond="spai", tol=1e-6)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _stats(ms: list) -> dict:
    return {"ms": ms, "median_ms": statistics.median(ms),
            "min_ms": min(ms), "max_ms": max(ms)}


def measure(tree: Path, reps: int, train: bool) -> dict:
    """One tree's warm solves in each state (see the module docstring)."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.api import ExecutionConfig, plan, pruned_linear
    from repro_torch.core.matrices import elasticity3d

    dev = torch.device("cuda")
    m = elasticity3d(NX)
    op = plan(m, execution=ExecutionConfig(format="ehyb_packed",
                                           partition_method="bfs"),
              device=dev).bind(m)
    rng = np.random.default_rng(SEED)
    rng.standard_normal(m.n)                 # chip_smoke.py's x
    b = torch.as_tensor(rng.standard_normal(m.n), dtype=torch.float32,
                        device=dev)
    first = op.solve(b, precond="spai", tol=1e-6)
    torch.cuda.synchronize()
    row = {"tree": str(tree), "iters": int(first.iters),
           "status": first.status, "alone": _stats(_warm_ms(op, b, reps))}

    rng_w = np.random.default_rng(SEED)
    w = rng_w.normal(0.0, 0.02, (D_MODEL, D_FF))
    layer = pruned_linear(w, 0.1, format="ehyb_packed",
                          partition_method="bfs", k=TOKENS, device=dev)
    tok = torch.as_tensor(rng_w.standard_normal((TOKENS, D_FF)),
                          dtype=torch.float32, device=dev)
    with torch.no_grad():
        layer(tok)
    torch.cuda.synchronize()
    row["layer"] = _stats(_warm_ms(op, b, reps))

    if train:
        target = torch.as_tensor(np.random.default_rng(SEED + 2)
                                 .standard_normal((TOKENS, D_MODEL)),
                                 dtype=torch.float32, device=dev)
        c = layer.csr
        rows = np.repeat(np.arange(c.n), c.row_lengths())
        cols = c.indices.astype(np.int64)
        for _ in range(3):
            loss = ((layer(tok) - target) ** 2).mean()
            loss.backward()
            w_next = np.zeros((D_MODEL, D_FF))
            w_next[rows, cols] = (layer.values - 0.5 * layer.values.grad) \
                .detach().double().cpu().numpy()
            layer.values.grad = None
            layer = layer.update_values(w_next)
        torch.cuda.synchronize()
        row["trained"] = _stats(_warm_ms(op, b, reps))
    return row


def drive(trees: list, rounds: int, reps: int, train: bool) -> int:
    """PARENT, CHANGE, CHANGE, PARENT a round, one process each."""
    parent, change = trees
    results = []
    for _ in range(rounds):
        for tree in (parent, change, change, parent):
            cmd = [sys.executable, __file__, "--src", str(tree),
                   "--reps", str(reps)]
            if train and tree == change:
                cmd.append("--train")
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 check=True).stdout
            row = json.loads(out.strip().splitlines()[-1])
            print(json.dumps(row), flush=True)
            results.append(row)
    for state in ("alone", "layer", "trained"):
        for tree in (parent, change):
            med = [r[state]["median_ms"] for r in results
                   if r["tree"] == str(tree) and state in r]
            if med:
                print(json.dumps({"state": state, "tree": str(tree),
                                  "run_medians_ms": med}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path)
    ap.add_argument("--pairs", help="PARENT,CHANGE tree directories")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("warm_solve: no CUDA device", file=sys.stderr)
        return 1
    if args.pairs:
        trees = [Path(p).resolve() for p in args.pairs.split(",")]
        return drive(trees, args.rounds, args.reps, args.train)
    if args.src is None:
        ap.error("give --src or --pairs")
    print(json.dumps(measure(args.src.resolve(), args.reps, args.train)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

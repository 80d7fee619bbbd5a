"""EHYB inside an LM: replace a dense FFN projection with a pruned sparse
layer (magnitude-pruned, explicit-caching SpMM) and measure agreement +
modeled bytes — then fine-tune the surviving weights THROUGH the operator
(fixed-mask value training: the gradient flows through ``plan.bind`` and
the operator's differentiable apply).

The port of ``examples/sparse_ffn_lm.py``: the same densities, the same 20
steps of value fine-tuning in ``ehyb`` with the same optimizer settings.

  PYTHONPATH=src python -m repro_torch.examples.sparse_ffn_lm [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.api.plan import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.train import (OptimizerConfig, init_opt_state,
                               make_sparse_value_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("llama3_2_1b", smoke=True)
    params = init_model(0, cfg, device=dev)
    # take unit 0's FFN
    w_down = params["units"]["b0"]["ffn"]["w_down"][0].double().cpu() \
        .numpy()                                       # (d_ff, d_model)

    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn((4, 16, cfg.d_ff), generator=gen, device=dev)
    y_dense = x @ torch.as_tensor(w_down, dtype=torch.float32, device=dev)

    for density in (0.5, 0.2, 0.05):
        lin = api.pruned_linear(w_down.T, density=density, format="ehyb",
                                partition_method="bfs", device=dev)
        # the layer computes y = A x with A (d_out, d_in); the dense op is
        # x @ W (d_ff, d_model), so A = W.T
        with torch.no_grad():
            y_sparse = lin(x)
        # compare against the *pruned* dense op (the approximation target)
        keep = max(1, int(w_down.size * density))
        thresh = np.partition(np.abs(w_down).ravel(), -keep)[-keep]
        w_pruned = np.where(np.abs(w_down) >= thresh, w_down, 0.0)
        y_pruned = x @ torch.as_tensor(w_pruned, dtype=torch.float32,
                                       device=dev)
        err = float((y_sparse - y_pruned).abs().max())
        b = lin.bytes_vs_dense()
        print(f"density={density:4.2f}: ehyb-vs-pruned-dense err={err:.2e}  "
              f"in-part={lin.ehyb.in_part_fraction:.1%}  "
              f"bytes ratio vs dense={b['ratio']:.2f}")
    print("(bytes ratio < 1 ⇒ the sparse layer moves less memory than "
          "dense; quality tradeoff is the pruning, not the format)")

    # fixed-mask value fine-tuning: the pruned layer's nnz values are the
    # trainable parameter
    lin = api.pruned_linear(w_down.T, density=0.2, format="ehyb", device=dev)
    plan = lin.op.plan
    xt = x.reshape(-1, cfg.d_ff).T[: lin.op.n]                # (n, T)
    y_goal = y_dense.reshape(-1, cfg.d_model).T               # target

    def loss_fn(op):
        d = (op @ xt)[: cfg.d_model] - y_goal
        return (d * d).sum() / d.numel()

    values = lin.values.detach().clone()
    opt_cfg = OptimizerConfig(lr=2e-2, warmup_steps=0, weight_decay=0.0,
                              clip_norm=1e9)
    opt = init_opt_state({"values": values})
    step = make_sparse_value_train_step(plan, loss_fn, opt_cfg)
    losses = []
    for _ in range(20):
        values, opt, metrics = step(values, opt)
        losses.append(float(metrics["loss"]))
    print(f"value fine-tuning (fixed mask, grad through the operator): "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} in 20 steps")
    return losses


if __name__ == "__main__":
    main()

"""Train step factory: loss, grad, microbatch accumulation, optimizer.

The port of ``repro.train.train_step``.  ``make_train_step(cfg, opt_cfg,
microbatches=)`` returns ``(train_state, batch) -> (train_state,
metrics)``.  Microbatch accumulation is a Python loop over batch slices
(the reference's ``lax.scan``): each slice's gradients are summed in fp32
and divided by ``microbatches``, so peak activation memory is that of one
slice while the optimizer still sees the full global batch.
``donate=True`` updates the state's tensors in place (the state passed in
is consumed, as the reference's ``donate_argnums=(0,)`` consumes it).

``make_sparse_value_train_step(plan, loss_fn, opt_cfg)`` trains the
``(nnz,)`` values of a fixed sparsity pattern through the operator: each
step binds them (``plan.bind(v)``, a scatter on the plan's device), runs
``loss_fn`` on the operator and its backward through the differentiable
apply (``api.operator._DiffApply``), then AdamW — no re-plan, no host work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import forward
from ..models.layers import cdtype, chunked_xent
from ..models.transformer import tree_leaves, tree_map
from .optimizer import (OptimizerConfig, OptState, adamw_update,
                        init_opt_state)


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    step: torch.Tensor


def init_train_state(params, cfg) -> TrainState:
    dev = next(iter(tree_leaves(params))).device
    return TrainState(params=params,
                      opt=init_opt_state(params, cfg.opt_state_dtype),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def cast_params_for_compute(params, cfg):
    """Cast fp32 master weights (≥2-D) to the compute dtype ONCE, before any
    use; the cast's backward still hands the fp32 master its gradient."""
    cdt = cdtype(cfg)
    return tree_map(
        lambda p: p.to(cdt) if (p.ndim >= 2 and p.dtype == torch.float32)
        else p, params)


def make_loss_fn(cfg, *, skip_causal=False):
    def loss_fn(params, batch):
        params_c = cast_params_for_compute(params, cfg)
        h, aux = forward(params_c, batch, cfg, skip_causal=skip_causal)
        nll = chunked_xent(params_c["head"], params_c["embed"], h,
                           batch["labels"], batch["mask"], cfg)
        return nll + aux, {"nll": nll, "moe_aux": aux}
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, extras, grads) of ``loss_fn(params, batch)`` with respect to
    every leaf of ``params`` (a leaf the loss does not reach gets zeros);
    nothing is left attached to the caller's tensors."""
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = list(tree_leaves(ps))
        loss, extras = loss_fn(ps, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(gs)
    grads = tree_map(lambda p: _or_zeros(next(it), p), ps)
    return (loss.detach(), {k: v.detach() for k, v in extras.items()},
            grads)


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def make_sparse_value_train_step(plan, loss_fn, opt_cfg: OptimizerConfig):
    """Train step over the nnz VALUES of a fixed sparsity pattern.

    The trainable parameter is the ``(nnz,)`` per-nnz value tensor;
    ``loss_fn(op) -> scalar`` consumes the
    :class:`repro_torch.api.LinearOperator` bound from it, and gradients
    flow through ``plan.bind`` (the value scatter) and the operator's
    differentiable apply.  The pattern, partitioning and device structure
    are fixed for the whole run: every step costs one bind, never a
    re-plan (the bind skips validation, which would read the values on the
    host, as the reference's traced bind does).

    Returns ``step(values, opt_state) -> (values, opt_state, metrics)``.
    Initialize with ``init_opt_state({"values": v0})``."""

    def step(values: torch.Tensor, opt_state: OptState):
        with torch.enable_grad():
            v = values.detach().requires_grad_(True)
            loss = loss_fn(plan.bind(v, validate=False))
            (g,) = torch.autograd.grad(loss, [v])
        new_p, new_opt, om = adamw_update({"values": values.detach()},
                                          {"values": g}, opt_state, opt_cfg)
        return new_p["values"], new_opt, {"loss": loss.detach(), **om}

    return step


def make_train_step(cfg, opt_cfg: OptimizerConfig, *, microbatches: int = 1,
                    skip_causal: bool = False, donate: bool = False):
    loss_fn = make_loss_fn(cfg, skip_causal=skip_causal)

    def train_step(state: TrainState, batch):
        if microbatches == 1:
            loss, extras, grads = value_and_grad(loss_fn, state.params, batch)
        else:
            b = len(batch["tokens"])
            if b % microbatches:
                raise ValueError(f"a batch of {b} rows does not split into "
                                 f"{microbatches} microbatches")
            rows = b // microbatches
            loss, grads = None, None
            for i in range(microbatches):
                micro = {k: v[i * rows:(i + 1) * rows]
                         for k, v in batch.items()}
                l, _, g = value_and_grad(loss_fn, state.params, micro)
                if grads is None:
                    loss, grads = l, tree_map(lambda t: t.float(), g)
                else:
                    loss = loss + l
                    tree_map(lambda a, t: a.add_(t), grads, g)
            loss = loss / microbatches
            tree_map(lambda a: a.div_(microbatches), grads)
            extras = {"nll": loss, "moe_aux": torch.zeros_like(loss)}
        new_params, new_opt, om = adamw_update(state.params, grads,
                                               state.opt, opt_cfg,
                                               in_place=donate)
        metrics = {"loss": loss, **extras, **om}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


__all__ = ["TrainState", "init_train_state", "cast_params_for_compute",
           "make_loss_fn", "make_train_step", "make_sparse_value_train_step",
           "value_and_grad"]

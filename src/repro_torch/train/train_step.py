"""Train step factory: loss, grad, microbatch accumulation, optimizer.

The port of ``repro.train.train_step``.  ``make_train_step(cfg, opt_cfg,
microbatches=)`` returns ``(train_state, batch) -> (train_state,
metrics)``.  Microbatch accumulation is a Python loop over batch slices
(the reference's ``lax.scan``): each slice's gradients are summed in fp32
and divided by ``microbatches``, so peak activation memory is that of one
slice while the optimizer still sees the full global batch.
``donate=True`` updates the state's tensors in place (the state passed in
is consumed, as the reference's ``donate_argnums=(0,)`` consumes it).

``make_train_step(..., mesh=)`` is the step on a device mesh (one process
a device): the state's params and moments are ``DTensor``s placed by
``launch.sharding``'s rules (``distribute_state``).  The step takes this
rank's block of the global batch (split over ``dp_axes``, or all of it
when the batch does not divide them; then microbatches), runs the model
with each unit's parameters all-gathered inside its remat boundary
(``shard_ctx.gather_param``) over every axis but `model` where the
leaf's `model` shard is aligned with its layer's split
(``launch.sharding.tp_layout``), and the layers split their compute over
`model` as the mesh prefill and decode do (``shard_ctx.tp_split``):
attention on heads, the MLP on d_ff, the experts on E or d_ff, the
embedding, head and loss on the vocab.  Under ``act_sharding="sp"`` the
residual stream between blocks is the rank's block of the sequence
(``launch.sharding.seq_axes``; the remat boundaries keep it), and the
norms on it have their gradients summed over `model` too.  Each
gradient is reduced to its leaf's spec in that gather's backward: a sum
over the ranks that saw other tokens — the batch's axes for a dense
leaf, the MoE's token split for the router and the experts, and `model`
too for a whole leaf that each model peer computes with on its own query
heads only — and a slice along the axes that shard the leaf, never a sum
over ranks that only repeat work.  Each rank's loss is its tokens'
share of the global mean, so the gradients and the metrics (loss, grad
norm) are the global batch's; AdamW updates the local shards.

``make_sparse_value_train_step(plan, loss_fn, opt_cfg)`` trains the
``(nnz,)`` values of a fixed sparsity pattern through the operator: each
step binds them (``plan.bind(v)``, a scatter on the plan's device), runs
``loss_fn`` on the operator and its backward through the differentiable
apply (``api.operator._DiffApply``), then AdamW — no re-plan, no host work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import forward, shard_ctx
from ..models.layers import cdtype, chunked_xent, head_input
from ..models.transformer import UNIT_KEYS, tree_leaves, tree_map
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
                    skip_causal: bool = False, donate: bool = False,
                    mesh=None):
    if mesh is not None:
        return make_mesh_train_step(cfg, opt_cfg, mesh,
                                    microbatches=microbatches,
                                    skip_causal=skip_causal, donate=donate)
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


# ---------------------------------------------------------------------------
# the step on a mesh
# ---------------------------------------------------------------------------

# the leaves that act on the residual stream between blocks: under
# sequence parallelism each rank reads them on its own block of the
# sequence, so their gradients are summed over its axes too
SEQ_NORMS = ("ln1", "ln2", "post_ln1", "post_ln2")


def _on_residual_stream(path) -> bool:
    return (path[0] == "final_norm" or path[-1] == "pos_embedding"
            or (path[0] in UNIT_KEYS and path[2] in SEQ_NORMS))


def mesh_gather_rules(specs, mesh, cfg, split_in, t: int, seq=()):
    """Per leaf of ``specs`` (the params' specs), the ``(spec, partial,
    keep)`` its gather takes: the axes its gradient is summed over and
    those that stay sharded in compute (``launch.sharding.tp_layout``'s
    `model`).  ``split_in``: the axes the batch is split over; ``t``: a
    microbatch's tokens in the whole batch; ``seq``: the axes the
    residual stream splits its sequence over.  A leaf kept on `model`
    holds other columns than its model peers' for the same tokens, and a
    leaf every model peer computes with alike (RWKV's ddlerp half, the
    norms without ``seq``) has its inputs' gradients summed by
    ``shard_ctx.copy_to``: both are summed over the batch's axes only — a
    whole leaf each peer reads on its own part (``tp_layout``'s
    ``partial``; the norms on the residual stream's blocks under
    ``seq``) over `model` too."""
    from ..launch.sharding import (MOE_EXPERT_LEAVES, _leaf_name,
                                   _map_with_path, dp_axes, tp_layout)
    from ..models.moe import moe_split

    split = (moe_split(t, mesh, dp_axes(mesh, cfg), cfg)[0]
             if cfg.n_experts else ())

    def one(path, spec, layout):
        keep, rank_part = layout
        name = _leaf_name(path)
        if path[0] in UNIT_KEYS:
            spec = spec[1:]                 # one unit of the stack
        if name == "router":
            return spec, split, ()
        if name in MOE_EXPERT_LEAVES:
            # the experts stay sharded over `model` where their specs put
            # them: a rank runs its own (the all-to-all brings the tokens)
            # or its block of d_ff
            return spec, tuple(a for a in split if a not in keep), keep
        if seq and _on_residual_stream(path):
            rank_part = tuple(rank_part) + tuple(
                a for a in seq if a not in rank_part)
        return spec, tuple(split_in) + rank_part, keep

    return _map_with_path(one, specs, tp_layout(specs, mesh, cfg))


def make_mesh_loss_fn(cfg, rules, mesh, split_in, *, skip_causal=False):
    """``loss_fn(local_params, local_batch)``: this rank's share of the
    global batch's loss (its tokens' nll sum over the batch's mask count,
    plus the MoE aux, which every rank computes alike), with the params
    gathered by ``rules`` (:func:`mesh_gather_rules`)."""
    def gather(key, up):
        return shard_ctx.gather_tree(up, rules[key], mesh)

    def loss_fn(params, batch):
        params_c = cast_params_for_compute(params, cfg)
        full = {k: v if k in UNIT_KEYS
                else shard_ctx.gather_tree(v, rules[k], mesh)
                for k, v in params_c.items()}
        h, aux = forward(full, batch, cfg, skip_causal=skip_causal,
                         gather=gather)
        h = head_input(full["head"], full["embed"], h, cfg)
        nll = chunked_xent(full["head"], full["embed"], h, batch["labels"],
                           batch["mask"], cfg)
        mask = torch.as_tensor(batch["mask"], device=h.device).float()
        cnt = mask.sum()
        share = cnt / torch.clamp(shard_ctx.reduce_sum(cnt, mesh, split_in),
                                  min=1.0)
        nll = nll * share
        return nll + aux, {"nll": nll, "moe_aux": aux}

    return loss_fn


def rank_microbatches(rows: int, microbatches: int) -> int:
    """The microbatches a rank's ``rows`` run in: ``microbatches``, or one
    row each when the rank holds fewer rows than that (a 2 × 16 × 16
    mesh gives jamba's 256-row batch 8 rows a rank for its 16
    microbatches, where the reference hands 16-row microbatches to GSPMD
    over 32 devices).  Raises when neither divides."""
    if rows % microbatches == 0:
        return microbatches
    if microbatches % rows == 0:
        return rows
    raise ValueError(f"a rank's {rows} rows do not split into "
                     f"{microbatches} microbatches")


def make_mesh_train_step(cfg, opt_cfg, mesh, *, microbatches=1,
                         skip_causal=False, donate=False, specs=None):
    """The step on ``mesh`` (``make_train_step(..., mesh=)``).  The state's
    params and moments are ``DTensor``s, or — with their ``specs`` given —
    this rank's local shards (as the dispatch lint runs it on a mesh
    stand-in)."""
    from ..launch.sharding import (dp_axes, make_shard_act, param_specs,
                                   seq_axes, tp_axes)
    from .optimizer import _local

    shard = make_shard_act(mesh, cfg)
    b_axes = dp_axes(mesh, cfg)
    tp = tp_axes(mesh, cfg)
    fixed_specs = specs

    def train_step(state: TrainState, batch):
        specs = fixed_specs or param_specs(state.params, mesh, cfg)
        dev = state.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        b, s = batch["tokens"].shape[:2]
        split_in = b_axes if b % shard_ctx.group_size(mesh, b_axes) == 0 \
            else ()
        local = {k: shard(v) for k, v in batch.items()}
        rows = len(local["tokens"])
        mb = rank_microbatches(rows, microbatches)
        seq = seq_axes(mesh, cfg, s)
        rules = mesh_gather_rules(specs, mesh, cfg, split_in, b // mb * s,
                                  seq)
        loss_fn = make_mesh_loss_fn(cfg, rules, mesh, split_in,
                                    skip_causal=skip_causal)
        params = tree_map(_local, state.params)
        saved = dict(shard_ctx._CTX)
        shard_ctx.set_sharding_context(mesh, b_axes, split=split_in, tp=tp,
                                       seq=seq)
        try:
            rows //= mb
            nll = aux = grads = None
            for i in range(mb):
                micro = {k: v[i * rows:(i + 1) * rows]
                         for k, v in local.items()}
                _, ex, g = value_and_grad(loss_fn, params, micro)
                n = shard_ctx.reduce_sum(ex["nll"], mesh, split_in)
                if grads is None:
                    grads = g if mb == 1 else tree_map(
                        lambda t: t.float(), g)
                    nll, aux = n, ex["moe_aux"]
                else:
                    tree_map(lambda a, t: a.add_(t), grads, g)
                    nll, aux = nll + n, aux + ex["moe_aux"]
        finally:
            shard_ctx._CTX.update(saved)
        loss = (nll + aux) / mb
        if mb == 1:
            extras = {"nll": nll, "moe_aux": aux}
        else:
            tree_map(lambda a: a.div_(mb), grads)
            extras = {"nll": loss, "moe_aux": torch.zeros_like(loss)}
        new_params, new_opt, om = adamw_update(
            state.params, grads, state.opt, opt_cfg, in_place=donate,
            specs=specs, mesh=mesh)
        metrics = {"loss": loss, **extras, **om}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


__all__ = ["TrainState", "init_train_state", "cast_params_for_compute",
           "make_loss_fn", "make_train_step", "make_sparse_value_train_step",
           "value_and_grad", "mesh_gather_rules", "make_mesh_loss_fn",
           "make_mesh_train_step", "rank_microbatches"]

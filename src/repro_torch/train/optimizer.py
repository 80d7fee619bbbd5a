"""AdamW with large-scale-training amenities.

The port of ``repro.train.optimizer``, with the reference's arithmetic:

* configurable moment dtype (``cfg.opt_state_dtype`` = bf16 for the ≥300B
  archs): moments are updated in fp32 and stored in the state's dtype;
* global-norm gradient clipping, applied first;
* linear-warmup + cosine-decay schedule, read at ``step + 1``, which is
  also the bias correction's step;
* weight decay on the leaves with ``ndim >= 2`` only;
* plain functions on nested dicts of tensors (no ``torch.optim``, whose
  clipping, schedule and decay rule differ).

``adamw_update(..., in_place=True)`` writes the new parameters and moments
into the tensors it was given — the analogue of the reference's
``donate_argnums=(0,)`` on the jitted step: the state held across steps is
one state, not two (a full-width llama3_2_1b's params and fp32 moments are
~14.8 GB).  The arithmetic is the same either way.  An in-place update
that fails part-way has already written some leaves, so it raises
:class:`PartialUpdateError`: the state it was given is no longer whole.

On a mesh the leaves are ``DTensor``s (or local shards with their specs
passed beside them): the update runs on each rank's shards, the decay rule
reads the global ndim (a shard has its leaf's), ``step`` is replicated,
and :func:`global_norm` counts every element once — it sums the squares
of the local shards and all-reduces them over the axes that shard each
leaf, never over the axes that replicate it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..models import shard_ctx
from ..models.transformer import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class PartialUpdateError(RuntimeError):
    """An in-place update failed after it began writing: some leaves of the
    parameters and moments hold the new step and others the old."""


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor


def _as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"bfloat16"``)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def init_opt_state(params, state_dtype=torch.float32) -> OptState:
    dt = _as_dtype(state_dtype)
    dev = next(iter(tree_leaves(params))).device
    return OptState(m=tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                               params),
                    v=tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                               params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_at(opt_cfg: OptimizerConfig, step) -> torch.Tensor:
    """The schedule at ``step`` (an int or an integer tensor), fp32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(opt_cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - opt_cfg.warmup_steps)
                       / max(opt_cfg.total_steps - opt_cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    floor = opt_cfg.min_lr_ratio
    return opt_cfg.lr * warm * (floor + (1 - floor) * cos)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _sharding(leaf, spec, mesh):
    """(local tensor, mesh, axes that shard it) of a plain, DTensor or
    local-shard leaf."""
    if isinstance(leaf, DTensor):
        from ..launch.sharding import spec_of

        return leaf.to_local(), leaf.device_mesh, shard_ctx.spec_axes(
            spec_of(leaf))
    return leaf, mesh, shard_ctx.spec_axes(spec) if spec else ()


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in fp32, every element counted once.
    ``tree``'s leaves are tensors, ``DTensor``s, or local shards whose
    specs (on ``mesh``) are the leaves of ``specs``."""
    spec_leaves = (list(tree_leaves(specs)) if specs is not None
                   else None)
    norms, groups = [], {}
    for i, leaf in enumerate(tree_leaves(tree)):
        x, m, axes = _sharding(leaf, None if spec_leaves is None
                               else spec_leaves[i], mesh)
        n = torch.linalg.vector_norm(x, dtype=torch.float32)
        if axes and shard_ctx.group_size(m, axes) > 1:
            groups.setdefault((id(m), axes), (m, []))[1].append(n * n)
        else:
            norms.append(n)
    for (_, axes), (m, sq) in groups.items():
        norms.append(torch.sqrt(shard_ctx.reduce_sum(
            torch.stack(sq).sum(), m, axes)))
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm, specs=None, mesh=None):
    norm = global_norm(grads, specs, mesh)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype),
                    tree_map(_local, grads)), norm


def _like(new: torch.Tensor, old):
    """``new`` (a local shard) as ``old``'s kind: a DTensor placed like
    ``old`` when ``old`` is one."""
    if not isinstance(old, DTensor):
        return new
    return DTensor.from_local(new, old.device_mesh, old.placements,
                              run_check=False, shape=old.shape,
                              stride=old.stride())


def adamw_update(params, grads, opt_state: OptState,
                 opt_cfg: OptimizerConfig, *, in_place: bool = False,
                 specs=None, mesh=None):
    """One AdamW step.  Returns (new_params, new_opt_state, metrics);
    ``in_place=True`` writes them into ``params`` and ``opt_state``'s
    tensors (which are returned) instead of new tensors.  Sharded leaves
    (``DTensor``s, or local shards with ``specs`` on ``mesh``) update
    their local shards."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm, specs,
                                           mesh)
        step = opt_state.step + 1
        lr = lr_at(opt_cfg, step)
        b1, b2 = opt_cfg.beta1, opt_cfg.beta2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()

        def upd(p_leaf, g, m_leaf, v_leaf):
            p, m, v = _local(p_leaf), _local(m_leaf), _local(v_leaf)
            gf = g.float()
            mf = m.float() * b1 + (1 - b1) * gf
            vf = v.float() * b2 + (1 - b2) * gf * gf
            mhat = mf / bc1
            vhat = vf / bc2
            delta = mhat / (torch.sqrt(vhat) + opt_cfg.eps)
            if p_leaf.ndim >= 2:  # decay matrices only (standard practice)
                delta = delta + opt_cfg.weight_decay * p.float()
            newp = p.float() - lr * delta
            if in_place:
                p.copy_(newp)
                m.copy_(mf)
                v.copy_(vf)
                return p_leaf, m_leaf, v_leaf
            return (_like(newp.to(p.dtype), p_leaf),
                    _like(mf.to(m.dtype), m_leaf),
                    _like(vf.to(v.dtype), v_leaf))

        try:
            out = tree_map(upd, params, grads, opt_state.m, opt_state.v)
        except Exception as exc:   # noqa: BLE001 — any failure mid-write
            if in_place:
                raise PartialUpdateError(
                    f"the in-place AdamW update failed part-way: {exc}") \
                    from exc
            raise
        new = [tree_map(lambda t, i=i: t[i], out) for i in range(3)]
    return new[0], OptState(new[1], new[2], step), {"grad_norm": gnorm,
                                                    "lr": lr}


__all__ = ["OptimizerConfig", "OptState", "PartialUpdateError",
           "init_opt_state", "lr_at", "global_norm", "clip_by_global_norm",
           "adamw_update"]

"""Ambient sharding context, and the collectives the mesh path runs on it.

The port of ``repro.models.shard_ctx``, its context: the launch layer sets
the mesh and the axes that shard batch-like dims (``set_sharding_context``)
before the model runs, and ``models.moe.apply_moe`` dispatches on it — the
distributed MoE path with a mesh, the single-device path without one.  The
port's context has one more entry, ``split``: the axes over which the
activations a layer receives are already split along the batch (the train
step sets it to the axes it split the global batch over; ``()``, the
default, means every rank holds the whole batch).

The reference's ``constrain`` (``with_sharding_constraint`` on an internal
tensor) has no eager meaning: there is no whole-program partitioner to
hint.  It is not ported.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (one process a
device) or a stand-in with ``.shape`` (name → size), ``.axis_names``,
``get_group(axes)`` and ``get_coordinate()`` — the dispatch lint runs the
mesh path on one such stand-in.  Every collective here names a group of
the mesh (:func:`axis_group`), never the default group, and runs in
autograd as Megatron's pairs do:

* :func:`scatter_to` — forward: the rank's slice; backward: all-gather;
* :func:`gather_from` — forward: all-gather; backward: the rank's slice
  (``sum_grad=True``: the gradient summed over the group first, for an
  output whose ranks read different parts of it);
* :func:`sum_over` — forward: all-reduce; backward: identity (the sum
  feeds a value every rank of the group computes alike);
* :func:`all_to_all` — forward and backward: one ``all_to_all_single``
  (:func:`exchange_blocks`: of uneven chunks, the backward the reverse
  exchange);
* :func:`copy_to` — forward: identity; backward: all-reduce (the input of
  a column-split matmul, which every rank of the group reads);
* :func:`gather_param` — forward: a leaf's shards all-gathered into the
  tensor a layer computes with; backward: the gradient summed over the
  ranks that saw other tokens (in fp32) and sliced back to the leaf's
  shard.

None of them sums a gradient over ranks that only repeat work: that
would multiply it by the group's size.  On a one-rank group each is the
identity, and none runs (:func:`_live`).

**Tensor-parallel compute** (the mesh train step, prefill and decode):
the context's ``tp`` entry names the axes the layers split their matmuls
over (``"model"``; ``()``, the default, splits none).  A leaf a layer
computes with is then either whole or the rank's block of it along the
dimension the layer splits (``gather_param(..., keep=tp)``), and the
layer reads which from its shape: a column split (:func:`copy_to`, then
the local matmul: the rank's columns of the product), a row split
(:func:`row_split`: the local matmul summed over the group), a
vocab-parallel lookup (:func:`vocab_lookup`) and a vocab-parallel loss
(``layers.chunked_xent``: the logsumexp over the vocab shards, with
:func:`reduce_max`).  A block reads its input through
:func:`enter_block` and hands its output back through
:func:`leave_block`; without sequence parallelism the activations
between blocks stay whole on every rank of the group, and those two are
:func:`copy_to` and :func:`sum_over`.

**Sequence parallelism** (Megatron's; the reference's
``act_sharding="sp"``): the context's ``seq`` entry names the axes the
residual stream between blocks splits its sequence over (`model`, the
``tp`` axes, set by the caller from ``launch.sharding.seq_axes`` where
they divide the sequence; ``()``, the default, none).  Each rank then
holds its block ``(B, S/|model|, d)``, and the norms, residual adds and
post-norms run on it.  :func:`enter_block` all-gathers the sequence
before a block (its backward a reduce-scatter, which sums the ranks'
parts of the gradient: no :func:`copy_to` beside it) and
:func:`leave_block` reduce-scatters a row split's partial sums onto the
blocks (its backward an all-gather); a block whose weights are whole is
gathered with a slice for backward and left with a slice.

**Context-parallel decode**: the context's ``ctx`` entry names the axes
a decode state's KV caches split their sequence over (``"data"`` under
``launch.sharding.state_specs(..., context_parallel=True)``; ``()``, the
default, none): each rank then holds its block of the sequence, and
``models.attention`` merges the blocks' softmax statistics over them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

_CTX: dict = {"mesh": None, "batch_axes": None, "split": (), "tp": (),
              "ctx": (), "seq": ()}


def set_sharding_context(mesh, batch_axes, split=(), tp=(), ctx=(),
                         seq=()) -> None:
    _CTX["mesh"] = mesh
    _CTX["batch_axes"] = tuple(batch_axes) if batch_axes else None
    _CTX["split"] = tuple(split or ())
    _CTX["tp"] = _axes(tp)
    _CTX["ctx"] = _axes(ctx)
    _CTX["seq"] = _axes(seq)


def tp_split():
    """``(mesh, axes)`` the layers split their matmuls over, or None."""
    if _CTX["mesh"] is None or not _CTX.get("tp"):
        return None
    return _CTX["mesh"], _CTX["tp"]


def ctx_split():
    """``(mesh, axes)`` the decode caches split their sequence over, or
    None."""
    if _CTX["mesh"] is None or not _CTX.get("ctx"):
        return None
    return _CTX["mesh"], _CTX["ctx"]


def seq_split():
    """``(mesh, axes)`` the residual stream splits its sequence over (a
    live group), or None."""
    mesh = _CTX["mesh"]
    if mesh is None or not _live(mesh, _CTX.get("seq")):
        return None
    return mesh, _CTX["seq"]


def clear_sharding_context() -> None:
    set_sharding_context(None, None)


# ---------------------------------------------------------------------------
# mesh geometry (a DeviceMesh or a stand-in)
# ---------------------------------------------------------------------------

def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh (whose ``.shape`` is a tuple)
    or of a stand-in (whose ``.shape`` is that mapping, as a jax mesh's
    is)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def group_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(axes))


def group_index(mesh, axes) -> int:
    """The rank's index in the group of ``axes``: its mesh coordinates over
    those axes, the first one major (a jax ``PartitionSpec`` entry's
    order)."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for a in _axes(axes):
        idx = idx * sizes[a] + int(coord[names.index(a)])
    return idx


_GROUPS: dict = {}


def axis_group(mesh, axes):
    """The process group of the ranks that differ only along ``axes`` (one
    name or several), its ranks in :func:`group_index` order for axes in
    mesh order.  One axis is the mesh's own group; several are made once a
    mesh (every rank makes them, in the same order, as a collective
    call)."""
    names = axis_names(mesh)
    axes = tuple(sorted(_axes(axes), key=names.index))
    if not hasattr(mesh, "mesh_dim_names"):          # a stand-in
        return mesh.get_group(axes[0] if len(axes) == 1 else axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    dims = [names.index(a) for a in axes]
    key = (id(mesh), axes)
    hit = _GROUPS.get(key)
    if hit is None or hit[0] is not mesh:
        # the rank table is host bookkeeping: read with every dispatch mode
        # off (under FakeTensorMode its ops would turn fake and have no
        # values), then reshaped in numpy
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            ranks = np.array(mesh.mesh.tolist())
        rest = [i for i in range(ranks.ndim) if i not in dims]
        rows = ranks.transpose(*rest, *dims).reshape(
            -1, math.prod(ranks.shape[d] for d in dims)).tolist()
        group, _ = dist.new_subgroups_by_enumeration(rows)
        hit = _GROUPS[key] = (mesh, group)
    return hit[1]


# ---------------------------------------------------------------------------
# collectives (each names a group of the mesh)
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    n = group_size(mesh, axes)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, xt, group=axis_group(mesh, axes))
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """``x`` summed over the group, the rank's block of ``dim`` kept."""
    n = group_size(mesh, axes)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    scatter(out, xt, group=axis_group(mesh, axes))
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    n = group_size(mesh, axes)
    rows = x.shape[dim] // n
    return x.narrow(dim, group_index(mesh, axes) * rows, rows)


def _all_reduce(x: torch.Tensor, mesh, axes,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=axis_group(mesh, axes))
    return x


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return _slice(x, dim, mesh, axes).clone()

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, *ctx.args), None, None, None)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, sum_grad):
        ctx.args = (dim, mesh, axes)
        ctx.sum_grad = sum_grad
        return _all_gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes = ctx.args
        if ctx.sum_grad:
            g = _all_reduce(g.clone(), mesh, axes)
        return (_slice(g, dim, mesh, axes).contiguous(), None, None, None,
                None)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), *ctx.args), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return _all_gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return _reduce_scatter(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, send=None, recv=None):
        ctx.args = (mesh, axes, recv, send)
        return _exchange(x, mesh, axes, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None, None


def _exchange(x: torch.Tensor, mesh, axes, send=None,
              recv=None) -> torch.Tensor:
    """One ``all_to_all_single``: even chunks of dim 0, or ``send[j]``
    rows to rank ``j`` and ``recv[j]`` rows from it."""
    x = x.contiguous()
    if send is None:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=axis_group(mesh, axes))
        return out
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, list(recv), list(send),
                           group=axis_group(mesh, axes))
    return out


def _live(mesh, axes) -> tuple:
    """``axes`` as a tuple, or ``()`` where their group is one rank (every
    collective on it is the identity)."""
    axes = _axes(axes)
    return axes if axes and group_size(mesh, axes) > 1 else ()


def scatter_to(x, dim, mesh, axes):
    """The rank's slice of ``x`` along ``dim`` over ``axes`` (backward:
    all-gather).  No-op for no axes or a one-rank group."""
    axes = _live(mesh, axes)
    return _ScatterTo.apply(x, dim, mesh, axes) if axes else x


def gather_from(x, dim, mesh, axes, sum_grad=False):
    """The group's slices of ``x`` along ``dim`` joined in group order
    (backward: the rank's slice, of the gradient summed over the group
    first with ``sum_grad`` — where the ranks go on to read different
    parts of the result, so each holds only its part of the gradient).
    No-op for no axes or a one-rank group."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    return _GatherFrom.apply(x, dim, mesh, axes, sum_grad)


def sum_over(x, mesh, axes):
    """``x`` summed over the group (backward: identity).  No-op for no
    axes or a one-rank group."""
    axes = _live(mesh, axes)
    return _SumOver.apply(x, mesh, axes) if axes else x


def copy_to(x, mesh, axes):
    """``x`` as it is (backward: the gradient summed over the group): the
    input of a column-split matmul, whose every rank reads all of it.
    No-op for no axes or a one-rank group."""
    axes = _live(mesh, axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def row_split(h, w, mesh, axes):
    """``h @ w`` for ``w`` the rank's block of rows and ``h`` the rank's
    block of columns alike: the local product summed over the group (the
    second half of a column-then-row split).  No sum for no axes."""
    return sum_over(h @ w, mesh, axes)


def enter_block(x, split: bool):
    """A block's input from the residual stream ``x`` (B, S, d).  Under a
    sequence-parallel context (:func:`seq_split`) the whole sequence,
    all-gathered from the ranks' blocks; its backward reduce-scatters
    where ``split`` (the block reads it through the rank's columns of a
    split weight, so each rank holds a part of the gradient), else keeps
    the rank's block of the gradient (every rank computed all of it
    alike).  Otherwise ``x``, through :func:`copy_to` where ``split``."""
    seq = seq_split()
    if seq is not None:
        return _SeqGather.apply(x, 1, *seq) if split else \
            gather_from(x, 1, *seq)
    tp = tp_split()
    return copy_to(x, *tp) if split and tp is not None else x


def leave_block(y, partial: bool):
    """A block's output ``y`` (B, S, d) onto the residual stream.  Under a
    sequence-parallel context the rank's block of the sequence:
    reduce-scattered where ``partial`` (each rank holds a part of the sum,
    a row split's), else sliced (backward: all-gather).  Otherwise ``y``
    summed over the tensor-parallel group where ``partial``."""
    seq = seq_split()
    if seq is not None:
        return _SeqScatter.apply(y, 1, *seq) if partial else \
            scatter_to(y, 1, *seq)
    tp = tp_split()
    return sum_over(y, *tp) if partial and tp is not None else y


def seq_block(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The rank's block of ``t`` along ``dim`` under a sequence-parallel
    context (an index tensor: positions), else ``t``."""
    seq = seq_split()
    return t if seq is None else _slice(t, dim % t.ndim, *seq)


def vocab_lookup(table, tokens, mesh, axes, dtype=None):
    """``table[tokens]`` for ``table`` the rank's block of rows of a table
    split over the group (vocab-parallel): the rank looks up the tokens in
    its range, zeroes the others, and the group sums (each token's row is
    one rank's, so the sum is exact); under a sequence-parallel context
    the sum is reduce-scattered onto the rank's block of the sequence
    (:func:`leave_block`).  Rows cast to ``dtype`` before the sum."""
    n = table.shape[0]
    local = tokens - group_index(mesh, axes) * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, torch.zeros_like(local))]
    rows = rows.to(dtype or rows.dtype)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    if seq_split() is not None:
        return leave_block(rows, True)
    return sum_over(rows, mesh, axes)


def all_to_all(x, mesh, axes):
    """One ``all_to_all_single`` over the group: dim 0 in ``n`` equal
    chunks, chunk ``j`` to rank ``j``, the received chunks stacked in
    rank order (its own backward).  No-op for a one-rank group."""
    axes = _live(mesh, axes)
    return _AllToAll.apply(x, mesh, axes) if axes else x


def exchange_blocks(x, mesh, axes, send, recv):
    """One ``all_to_all_single`` of uneven chunks over the group: the
    first ``send[0]`` rows of dim 0 to rank 0, the next ``send[1]`` to
    rank 1, ...; the result the ``recv[j]`` rows from each rank ``j``,
    stacked in rank order.  Backward: the reverse exchange.  Needs a live
    group."""
    axes = _live(mesh, axes)
    if not axes:
        raise ValueError("exchange_blocks needs a group of two or more "
                         "ranks")
    return _AllToAll.apply(x, mesh, axes, tuple(send), tuple(recv))


# ---------------------------------------------------------------------------
# parameters: a leaf's shards gathered for compute
# ---------------------------------------------------------------------------

def spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over, in the order they appear."""
    out = []
    for entry in spec:
        out += [a for a in _axes(entry) if a not in out]
    return tuple(out)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, partial):
        ctx.args = (spec, mesh, partial)
        out = x.view_as(x)
        for d, entry in enumerate(spec):
            if _axes(entry):
                out = _all_gather(out, d, mesh, entry)
        return out

    @staticmethod
    def backward(ctx, g):
        spec, mesh, partial = ctx.args
        dt = g.dtype
        g = g.float()
        if partial:
            g = _all_reduce(g, mesh, partial)
        for d, entry in enumerate(spec):
            if _axes(entry):
                g = _slice(g, d, mesh, entry)
        return g.to(dt).contiguous(), None, None, None


def gather_param(x: torch.Tensor, spec, mesh, partial=(),
                 keep=()) -> torch.Tensor:
    """The tensor a layer computes with from a leaf's local shard ``x``
    under ``spec`` (one entry a dim: None, an axis, or a tuple of axes),
    gathered over every axis but those in ``keep`` (which stay sharded).
    Backward: the gradient summed over ``partial`` — the axes whose ranks
    saw other tokens — then sliced back to the shard.  One-rank groups
    are skipped."""
    spec = tuple(None if entry is None or set(_axes(entry)) & set(keep)
                 or not _live(mesh, entry) else entry for entry in spec)
    partial = _live(mesh, partial)
    if not spec_axes(spec) and not partial:
        return x
    return _GatherParam.apply(x, spec, mesh, partial)


def gather_tree(tree, rules, mesh):
    """:func:`gather_param` over a tree of dicts, each leaf by its rule
    ``(spec, partial, keep)`` at the same path of ``rules``."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, rules[k], mesh) for k, v in tree.items()}
    spec, partial, keep = rules
    return gather_param(tree, spec, mesh, partial=partial, keep=keep)


def reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` summed over the group of ``axes``, outside autograd (metrics,
    norms, counts)."""
    if not _live(mesh, axes):
        return x
    return _all_reduce(x.detach().clone(), mesh, axes)


def reduce_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise largest ``x`` over the group of ``axes``, outside
    autograd (a logsumexp's shift, which its value does not depend on)."""
    if not _live(mesh, axes):
        return x.detach()
    return _all_reduce(x.detach().clone(), mesh, axes, dist.ReduceOp.MAX)


__all__ = ["set_sharding_context", "clear_sharding_context", "tp_split",
           "axis_names", "axis_sizes", "group_size", "group_index",
           "axis_group", "scatter_to", "gather_from", "sum_over", "copy_to",
           "row_split", "vocab_lookup", "all_to_all", "exchange_blocks",
           "ctx_split", "seq_split", "enter_block", "leave_block",
           "seq_block",
           "spec_axes", "gather_param", "gather_tree", "reduce_sum",
           "reduce_max"]

"""Per-device cost of one rank's step, counted from the ops it dispatches.

The counterpart of ``repro.roofline.hlo_cost``.  Eager PyTorch has no
whole-step program to parse, so :class:`OpCost` is a ``TorchDispatchMode``
that sees every aten and c10d op one rank's step dispatches — the SPMD
program every rank of the mesh runs — and counts, per device:

* **flops** — 2·M·N·K of each ``mm``, ``addmm``, ``bmm`` and ``baddbmm``
  (what ``matmul``, ``linear`` and ``einsum`` decompose to): the dot
  products the reference counts.  Elementwise flops and convolutions are
  not counted, as the reference does not count them;
* **bytes** — operands plus results of every op but views and
  allocations (``bytes``, the reference's upper bound), and of the
  matmuls alone (``dot_bytes``, the memory term's input);
* **collective bytes** — ``max(operand, result)`` bytes of each
  all-gather, all-reduce, reduce-scatter, all-to-all and broadcast, by op,
  by the mesh axes of its group, by the link its group crosses
  (``analysis.link_of``), and the ``top_k`` largest by op and shape;
* **peak live bytes** — the storages alive at the start (the step's
  arguments, :meth:`OpCost.hold`), plus every storage an op creates, less
  each one freed (a weak reference on the storage: views and in-place ops
  add nothing, and remat's recompute adds what it allocates again).

It counts real tensors as well as fake ones (``FakeTensorMode``: shapes
only, nothing allocated), so one rank of a ``fake`` process group of 256
ranks can be costed on a CPU.

**Repeats** (``scaled=True``): every remat region of the port
(``models.layers.remat``: a unit of the stack, a chunk of the Mamba or
RWKV scan, a chunk of the loss) is run once per signature (the function,
its tensors' shapes, strides and dtypes, its other arguments by value, a
closure by its code and what it closes over, else by identity) on its
own, forward and backward, and every call is then replayed by one
autograd node that adds the measured counts and allocates the region's
outputs (forward) and its inputs' gradients (backward).  A region inside
one being measured (a scan chunk inside a unit) is not replayed: it runs
in torch's nested checkpoint, which keeps and frees what a replay cannot
mirror, so a unit's measurement is its own run.  That is
``hlo_cost``'s body cost × trip count; the peak follows the same replay:
at each call, the live bytes plus the region's own excess over its start.
A backward is measured from the gradients the region receives, laid out
as they are and alive as long: one the engine hands to other nodes too
(the aux loss's, which ``aux + a`` gives every unit) outlives the
region's backward, one the region alone holds is freed when it is read.
A replayed region's outputs hold no values, so only a fake run may scale
(:meth:`OpCost.hold` refuses a real tensor).  The replay is set through
``models.layers.remat_through``, for the thread that enters the mode.
"""

from __future__ import annotations

import contextlib
import gc
import weakref
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from .analysis import link_of

_REAL = ("a scaled count replays regions with outputs that hold no "
         "values: it runs on fake tensors only (FakeTensorMode)")

COLLECTIVE_KEYS = ("all-reduce", "all-gather", "reduce-scatter",
                   "all-to-all", "collective-permute", "broadcast")

_MATMULS = ("mm", "addmm", "bmm", "baddbmm")

# ops that move no data: views, metadata and allocations
_FREE = {"empty", "empty_like", "new_empty", "empty_strided",
         "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
         "resize_"}


def _collective_name(func) -> Optional[str]:
    ns = func.namespace
    name = func._schema.name.split("::")[-1]
    if ns == "c10d":
        if "allreduce" in name:
            return "all-reduce"
        if "allgather" in name:
            return "all-gather"
        if "reduce_scatter" in name:
            return "reduce-scatter"
        if "alltoall" in name:
            return "all-to-all"
        if "broadcast" in name:
            return "broadcast"
        if name in ("send", "recv_", "recv_any_source_"):
            return "collective-permute"
        return None
    if ns in ("_c10d_functional", "_c10d_functional_autograd"):
        if name.startswith("all_reduce"):
            return "all-reduce"
        if name.startswith("all_gather"):
            return "all-gather"
        if name.startswith("reduce_scatter"):
            return "reduce-scatter"
        if name.startswith("all_to_all"):
            return "all-to-all"
        if name.startswith("broadcast"):
            return "broadcast"
    return None


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_of(func, args, kwargs):
    """The process group a collective names: a c10d op's boxed group, a
    functional collective's group name (its last string argument)."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import ProcessGroup

    if func.namespace == "c10d":
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    return ProcessGroup.unbox(a)
                except RuntimeError:      # a ReduceOp or Work: not a group
                    continue
    else:
        from torch.distributed.distributed_c10d import _resolve_process_group

        names = [a for a in list(args) + list(kwargs.values())
                 if isinstance(a, str)]
        if names:
            return _resolve_process_group(names[-1])
    return dist.group.WORLD if dist.is_initialized() else None


class Tally:
    """Counts of one stretch of ops (a step, or one region's forward or
    backward)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.dot_bytes = 0.0
        self.coll_bytes = 0.0
        self.n_ops = 0
        self.coll_by_op: Dict[str, float] = {}
        self.coll_by_axis: Dict[str, float] = {}
        self.coll_by_link: Dict[str, float] = {}
        self.coll_top: Dict[str, float] = {}
        self.coll_calls: list = []         # (op, bytes) in dispatch order

    def add(self, other: "Tally", times: int = 1) -> None:
        self.flops += times * other.flops
        self.bytes += times * other.bytes
        self.dot_bytes += times * other.dot_bytes
        self.coll_bytes += times * other.coll_bytes
        self.n_ops += times * other.n_ops
        for mine, theirs in ((self.coll_by_op, other.coll_by_op),
                             (self.coll_by_axis, other.coll_by_axis),
                             (self.coll_by_link, other.coll_by_link),
                             (self.coll_top, other.coll_top)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0.0) + times * v
        self.coll_calls += other.coll_calls * times


class _Entry:
    """One checkpoint region: its forward, measured at its first call, and
    its backward, measured at the first backward call for each layout of
    the gradients it receives."""

    def __init__(self, fn, spec):
        self.fn, self.spec = fn, spec
        self.fwd = Tally()
        self.fwd_excess = 0
        self.out_spec = None
        self.out_meta: list = []       # (shape, stride, dtype, device, grad)
        self.bwd: dict = {}            # gradient layouts -> (Tally, excess,
        self.calls = 0                 #   each input's gradient meta)


def _flatten(obj, leaves):
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("T",)
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(_flatten(o, leaves) for o in obj))
    if isinstance(obj, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in obj.items()))
    return ("C", obj)


def _unflatten(spec, it):
    tag = spec[0]
    if tag == "T":
        return next(it)
    if tag == "C":
        return spec[1]
    if tag is dict:
        return {k: _unflatten(s, it) for k, s in spec[1]}
    return tag(_unflatten(s, it) for s in spec[1])


def _key_of(x):
    """A hashable stand-in of an argument's non-tensor part."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, str(x.device),
                x.requires_grad)
    if isinstance(x, (tuple, list)):
        return (type(x),) + tuple(_key_of(o) for o in x)
    if isinstance(x, dict):
        return (dict,) + tuple((k, _key_of(v)) for k, v in x.items())
    if callable(x) and getattr(x, "__closure__", None):
        # a closure made anew at each call (a unit's gather, once a
        # microbatch) is the same function: its code and what it closes
        # over
        return ("fn", x.__code__,
                tuple(_hashable(c.cell_contents) for c in x.__closure__))
    return _hashable(x)


def _hashable(x):
    try:
        hash(x)
        return x
    except TypeError:
        return ("id", id(x))


class _Replay(torch.autograd.Function):
    """One call of a measured region: its counts, its outputs (forward)
    and its inputs' gradients (backward), allocated without values."""

    @staticmethod
    def forward(ctx, cost, entry, *ins):
        cost._bump(cost.live + entry.fwd_excess)
        cost.tally.add(entry.fwd)
        with cost.paused():
            outs = [torch.empty_strided(shape, stride, dtype=dt, device=dev)
                    for shape, stride, dt, dev, _ in entry.out_meta]
        ctx.mark_non_differentiable(*[o for o, m in zip(outs, entry.out_meta)
                                      if not m[4]])
        ctx.set_materialize_grads(False)
        ctx.cost, ctx.entry = cost, entry
        # a checkpoint keeps its inputs for the recompute until its
        # backward has run: so does its replay
        ctx.keep = ins
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        cost, entry, ins = ctx.cost, ctx.entry, ctx.keep
        # a gradient held elsewhere too (one the engine hands to several
        # nodes, as ``aux + a`` does) outlives this backward: its layout
        # and whether it is shared
        layout = tuple(None if g is None else
                       (g.stride(), g.dtype, g._use_count() > 1)
                       for g in gouts)
        hit = entry.bwd.get(layout)
        if hit is None:
            hit = entry.bwd[layout] = cost._measure_bwd(entry, ins, gouts,
                                                         layout)
        tally, excess, made = hit
        cost._bump(cost.live + excess)
        cost.tally.add(tally)
        with cost.paused():
            grads = [None if m is None else torch.empty_strided(
                m[0], m[1], dtype=m[2], device=m[3]) for m in made]
        ctx.keep = None
        return (None, None, *grads)


class _Sink(torch.autograd.Function):
    """The far end of a measured region's backward: its gradients come
    from here, laid out as the caller's were, uncounted; a shared one is
    kept alive until the measurement ends, as the caller's is."""

    @staticmethod
    def forward(ctx, cost, gouts, shared, *outs):
        ctx.cost, ctx.shared = cost, shared
        ctx.meta = [None if g is None else
                    (tuple(g.shape), g.stride(), g.dtype, g.device)
                    for g in gouts]
        return outs[0].new_empty(())

    @staticmethod
    def backward(ctx, _):
        cost = ctx.cost
        with cost.paused():
            g = [None if m is None else
                 torch.empty_strided(m[0], m[1], dtype=m[2], device=m[3])
                 for m in ctx.meta]
        cost._kept += [x for x, s in zip(g, ctx.shared) if s]
        cost._bwd_base = cost.live
        cost.high = cost.live
        return (None, None, None, *g)


class OpCost(TorchDispatchMode):
    """Count what the ops run under it cost (see the module docstring).

    ``mesh``: the ``DeviceMesh`` whose axes name each collective's group
    (a group that is no axis set of the mesh is keyed by its ranks).
    ``scaled``: replay checkpoint regions (fake runs only)."""

    def __init__(self, mesh=None, *, scaled: bool = False):
        super().__init__()
        self.tally = Tally()
        self.live = 0
        self.high = 0
        self.arg_bytes = 0
        self.scaled = scaled
        self._paused = 0
        self._storages: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._groups: Dict[int, tuple] = {}
        self._axis_ranks = self._mesh_groups(mesh)
        self._memo: Dict[tuple, _Entry] = {}
        self._remat = None
        self._measuring = 0
        self._kept: list = []
        self._bwd_base = 0

    # -- storages ------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        """Track ``t``'s storage; returns the bytes it added (0 if seen)."""
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return 0               # a wrapper subclass: its parts are tracked
        key = id(st)
        if key in self._storages:
            return 0
        n = int(st.nbytes())
        self._storages[key] = n
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
        self.live += n
        return n

    def _free(self, key: int) -> None:
        n = self._storages.pop(key, None)
        self._refs.pop(key, None)
        if n is not None:
            self.live -= n

    def _bump(self, v: int) -> None:
        if v > self.high:
            self.high = v

    def hold(self, *trees) -> int:
        """Track the storages of every tensor in ``trees`` (the step's
        arguments: alive when it starts); returns the bytes added.  A
        scaled count takes fake tensors only: a replayed region's outputs
        hold no values, which a real step would go on computing with."""
        held = list(local_tensors(trees))
        if self.scaled and not all(isinstance(t, FakeTensor) for t in held):
            raise ValueError(_REAL)
        n = sum(self._track(t) for t in held)
        self.arg_bytes += n
        self._bump(self.live)
        return n

    @contextlib.contextmanager
    def paused(self):
        """Ops inside are not counted (their storages still are)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- collectives -----------------------------------------------------------
    @staticmethod
    def _mesh_groups(mesh):
        """``{frozenset of rank 0's group ranks: axes}`` for every
        non-empty set of the mesh's axes."""
        if mesh is None or not hasattr(mesh, "mesh_dim_names"):
            return {}
        import itertools

        import numpy as np
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            ranks = np.array(mesh.mesh.tolist())
        names = tuple(mesh.mesh_dim_names)
        coord = [int(c) for c in mesh.get_coordinate()]
        out = {}
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(range(len(names)), k):
                idx = tuple(slice(None) if d in axes else coord[d]
                            for d in range(len(names)))
                out[frozenset(ranks[idx].reshape(-1).tolist())] = \
                    ",".join(names[d] for d in axes)
        return out

    def _group_info(self, func, args, kwargs) -> tuple:
        import torch.distributed as dist

        pg = _group_of(func, args, kwargs)
        if pg is None:
            return "world", "nvlink"
        hit = self._groups.get(id(pg))
        if hit is None:
            ranks = dist.get_process_group_ranks(pg)
            axis = self._axis_ranks.get(frozenset(ranks),
                                        f"ranks{len(ranks)}")
            hit = self._groups[id(pg)] = (axis, link_of(ranks), pg)
        return hit[0], hit[1]

    # -- dispatch ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        for t in _tensors(out):
            self._track(t)
        self._bump(self.live)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        t = self.tally
        name = func._schema.name.split("::")[-1]
        coll = _collective_name(func)
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        if coll is not None:
            if func.namespace == "c10d":
                # in place: (tensors[, inputs], group, ...); the operands
                # are the outputs, so the bytes are the larger of the two
                first = sum(_nbytes(x) for x in _tensors(args[0]))
                second = (sum(_nbytes(x) for x in _tensors(args[1]))
                          if len(args) > 1 and next(_tensors(args[1]), None)
                          is not None else first)
                b, moved = float(max(first, second)), float(first + second)
            else:
                in_b = sum(_nbytes(x) for x in ins)
                out_b = sum(_nbytes(x) for x in _tensors(out))
                b, moved = float(max(in_b, out_b)), float(in_b + out_b)
            axis, link = self._group_info(func, args, kwargs)
            t.coll_bytes += b
            t.coll_by_op[coll] = t.coll_by_op.get(coll, 0.0) + b
            t.coll_by_axis[axis] = t.coll_by_axis.get(axis, 0.0) + b
            t.coll_by_link[link] = t.coll_by_link.get(link, 0.0) + b
            x0 = next(_tensors(args), None)
            shape = list(x0.shape) if x0 is not None else []
            dt = str(x0.dtype).replace("torch.", "") if x0 is not None \
                else ""
            key = f"{coll} {dt}{shape} over {axis}"
            t.coll_top[key] = t.coll_top.get(key, 0.0) + b
            t.coll_calls.append((coll, axis, b))
            t.n_ops += 1
            t.bytes += moved
            return
        if name in _FREE or func.is_view or \
                next(_tensors(out), None) is None:
            return                   # a view, an allocation or a query
        t.n_ops += 1
        b = float(sum(_nbytes(x) for x in ins)
                  + sum(_nbytes(x) for x in _tensors(out)))
        t.bytes += b
        if name in _MATMULS and func.namespace == "aten":
            a = args[0] if name in ("mm", "bmm") else args[1]
            t.flops += 2.0 * _out_numel(out) * a.shape[-1]
            t.dot_bytes += b

    # -- repeats -------------------------------------------------------------------
    def __enter__(self):
        if self.scaled:
            from ..models.layers import remat_through

            self._remat = remat_through(self._replayed)
            self._remat.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._remat is not None:
                self._remat.__exit__(None, None, None)
                self._remat = None

    def _replayed(self, fn, *args):
        """One call of a remat region (``models.layers.remat``): measured
        at its signature's first call, then replayed.  A region inside
        one being measured (a scan chunk in a unit) runs as it is, in
        torch's nested checkpoint, so the measurement is the region's own
        run, memory included."""
        if self._measuring:
            return checkpoint(fn, *args, use_reentrant=False)
        leaves: list = []
        spec = _flatten(args, leaves)
        if not all(isinstance(t, FakeTensor) for t in leaves):
            raise ValueError(_REAL)
        key = (fn, _key_of(args))
        entry = self._memo.get(key)
        if entry is None:
            entry = self._memo[key] = _Entry(fn, spec)
            self._measure_fwd(entry, leaves)
        entry.calls += 1
        outs = _Replay.apply(self, entry, *leaves)
        return _unflatten(entry.out_spec, iter(outs))

    @contextlib.contextmanager
    def _scope(self, tally: Tally):
        """Count into ``tally`` and track a high-water mark of its own;
        the enclosing scope sees neither."""
        saved = (self.tally, self.high)
        live0 = self.live
        self.tally, self.high = tally, live0
        self._measuring += 1
        try:
            with torch.enable_grad():
                yield live0
        finally:
            self.tally, self.high = saved
            self._measuring -= 1

    def _run(self, entry: _Entry, leaves):
        """The region on detached copies of its inputs: (inputs, outputs)."""
        with self.paused():
            ins = [t.detach().requires_grad_(t.requires_grad)
                   for t in leaves]
        out = checkpoint(entry.fn, *_unflatten(entry.spec, iter(ins)),
                         use_reentrant=False)
        outs: list = []
        spec = _flatten(out, outs)
        return ins, outs, spec

    def _measure_fwd(self, entry: _Entry, leaves) -> None:
        """The region's forward on its own: counts, the high-water mark
        above its start, and its outputs' metas."""
        with self._scope(entry.fwd) as live0:
            ins, outs, entry.out_spec = self._run(entry, leaves)
            entry.fwd_excess = self.high - live0
            entry.out_meta = [(tuple(o.shape), o.stride(), o.dtype,
                               o.device, o.requires_grad) for o in outs]
            del ins, outs
        self._settle(live0)

    def _measure_bwd(self, entry: _Entry, leaves, gouts, layout) -> tuple:
        """The region's backward on its own from gradients laid out as
        ``gouts`` (``layout``: which of them are shared): (counts,
        high-water mark above the point where those gradients exist, grad
        made per input)."""
        tally = Tally()
        with self._scope(Tally()) as live0:       # the forward: not counted
            ins, outs, _ = self._run(entry, leaves)
            diff = [(o, g, lay) for o, g, lay in zip(outs, gouts, layout)
                    if o.requires_grad]
            want = [t for t in ins if t.requires_grad]
            made = [None] * len(ins)
            excess = 0
            if want and any(g is not None for _, g, _ in diff):
                with self.paused():
                    anchor = _Sink.apply(
                        self, [g for _, g, _ in diff],
                        [lay is not None and lay[2] for _, _, lay in diff],
                        *[o for o, _, _ in diff])
                    seed = anchor.new_empty(())
                self.tally = tally
                grads = iter(torch.autograd.grad(anchor, want, seed,
                                                 allow_unused=True))
                excess = self.high - self._bwd_base
                # each gradient's layout, as the next op will read it
                made = [(g.shape, g.stride(), g.dtype, g.device)
                        if t.requires_grad and (g := next(grads)) is not None
                        else None for t in ins]
                del anchor, seed, grads
            del ins, outs, diff, want
            self._kept.clear()
        self._settle(live0)
        return tally, excess, made

    def _settle(self, live0: int) -> None:
        """A measurement's temporaries are gone once it ends (a cycle
        among them waits for the collector)."""
        if self.live != live0:
            gc.collect()

    # -- results -------------------------------------------------------------------
    def result(self, top_k: int = 12) -> dict:
        """The counts, ``peak_bytes`` (the high-water mark of live
        storages, the held arguments included), ``argument_bytes`` (held)
        and ``regions`` (replayed checkpoint calls by region function,
        those made while measuring an enclosing region included)."""
        t = self.tally
        regions: Dict[str, int] = {}
        for e in self._memo.values():
            name = getattr(e.fn, "__name__", str(e.fn))
            regions[name] = regions.get(name, 0) + e.calls
        top = sorted(t.coll_top.items(), key=lambda kv: -kv[1])[:top_k]
        return {
            "flops": t.flops, "bytes": t.bytes, "dot_bytes": t.dot_bytes,
            "coll_bytes": t.coll_bytes,
            "coll_by_op": {k: int(v) for k, v in t.coll_by_op.items()},
            "coll_by_axis": {k: int(v) for k, v in t.coll_by_axis.items()},
            "coll_by_link": {k: int(v) for k, v in t.coll_by_link.items()},
            "coll_top": [{"op": k, "bytes": int(v)} for k, v in top],
            "coll_calls": [[op, axis, int(b)] for op, axis, b in
                           t.coll_calls],
            "n_ops": t.n_ops,
            "argument_bytes": self.arg_bytes,
            "peak_bytes": self.high,
            "regions": regions,
        }


def _out_numel(out) -> int:
    t = next(_tensors(out))
    return t.numel()


def local_tensors(tree):
    """Every tensor of a tree of dicts, lists and tuples (a ``DTensor``'s
    local shard in its place)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        for v in tree.values():
            yield from local_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from local_tensors(v)
    elif isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree


def count(fn, *args, mesh=None, hold=(), scaled=False, top_k=12) -> dict:
    """``fn(*args)`` run under :class:`OpCost`: its :meth:`OpCost.result`,
    with the storages of ``hold`` (default: ``args``) alive at the start."""
    cost = OpCost(mesh, scaled=scaled)
    cost.hold(*(hold or args))
    with cost:
        fn(*args)
    return cost.result(top_k)


def collective_bytes(fn, *args, mesh=None) -> Dict[str, int]:
    """Bytes a collective op of ``fn(*args)``, with their ``total`` (the
    reference's ``collective_bytes`` of an HLO module)."""
    r = count(fn, *args, mesh=mesh)
    out = {k: r["coll_by_op"].get(k, 0) for k in COLLECTIVE_KEYS}
    out["total"] = int(r["coll_bytes"])
    return out


__all__ = ["OpCost", "Tally", "count", "collective_bytes", "local_tensors",
           "COLLECTIVE_KEYS"]

"""Dispatch lint (static analysis pass 2 of 3) — the counterpart of the
reference's jaxpr sanitizer (``repro.analysis.jaxpr_lint``).

Eager PyTorch has no program to walk, so the port runs every registered
apply instead — original and permuted space, K = 1 and K = 4, fp32, bf16
and fp64, on a small probe matrix on the CPU (where every format runs its
plain path, the oracle of the card's kernels) — under a
``TorchDispatchMode`` that records each aten op with the dtypes and
devices of its tensors, and checks the record:

  dtype-downcast    an op with a float64 input gives a narrower float
                    output (precision loss the caller never asked for)
                    — error
  bf16-accum        an ``mm``/``sum``/``index_add``/``scatter_add``
                    (or a relative: ``bmm``, ``addmm``, ``mv``, ``dot``,
                    ``scatter_reduce``) over bf16 operands has a bf16
                    result (the §4 mixed-precision discipline: bf16 in,
                    fp32 accumulate) — warning, ratcheted
  host-callback     a host sync inside an apply: ``_local_scalar_dense``
                    (``.item()``, ``int(t)``, a tensor in an ``if``) or a
                    copy of a tensor from another device to the CPU — each
                    stalls the card's queue — error
  trace-failure     the apply raised — error
  collective-axis   a ``torch.distributed`` collective of a sharded apply
                    or solve that does not name the plan's process group
                    (the default group, or another one) — such a program
                    works only by accident of which groups exist — error

``collective-axis`` is the counterpart of the reference's rule for a
``shard_map``-ed program: the sharded applies (original and permuted
space, K = 1 and 4) and the sharded CG and BiCGStab run on one rank's
shard of the probe matrix under a recorder that stands in for the
collectives (:func:`record_collectives`) and notes the group each names.
The mesh path (:func:`mesh_paths`) runs the same way on rank 0 of a
(data=2, model=2) mesh stand-in (:class:`LintMesh`): the distributed MoE's
forward and backward (the all-to-alls, the token gathers, the Switch
statistics' sums) in both expert modes, and the mesh train step of three
smoke configs (each unit's parameter gathers and their gradient
reductions, the loss's counts, the global norm's sums); each collective
must name a group the mesh handed out.
The reference's ``oversized-const`` is dropped: it checks constants closed
into a traced program, and eager torch closes over none (container tables
arrive as arguments by construction).

``run_dispatch_lint()`` sweeps every registered format and the sharded
paths; ``python -m repro_torch.analysis`` gates it against the port's
baseline.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..launch.mesh import ShapeMesh
from .findings import Finding

__all__ = ["lint_ops", "record_ops", "run_dispatch_lint",
           "registered_paths", "record_collectives", "lint_collectives",
           "run_collective_lint", "LintMesh", "mesh_paths"]

_FLOAT_WIDTH = {torch.float16: 2, torch.bfloat16: 2, torch.float32: 4,
                torch.float64: 8}
# accumulating ops: a bf16 result means the sum was carried in bf16
_ACCUM_OPS = {"mm", "bmm", "addmm", "addmv", "mv", "dot", "baddbmm",
              "sum", "index_add", "index_add_", "scatter_add",
              "scatter_add_", "scatter_reduce", "scatter_reduce_"}
_SYNC_OPS = {"_local_scalar_dense"}
_COPY_OPS = {"_to_copy", "copy_", "_copy_from"}


class _Op:
    """One recorded aten op: its name and its tensors' (dtype, device)."""

    __slots__ = ("name", "ins", "outs")

    def __init__(self, name: str, ins: list, outs: list):
        self.name, self.ins, self.outs = name, ins, outs


def _tensors(tree) -> list:
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append((v.dtype, v.device))
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)
    walk(tree)
    return out


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: List[_Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append(_Op(func.overloadpacket.__name__,
                            _tensors((args, kwargs)), _tensors(out)))
        return out


def record_ops(fn, *args) -> List[_Op]:
    """Run ``fn(*args)`` and return the aten ops it dispatched."""
    rec = _Recorder()
    with rec:
        fn(*args)
    return rec.ops


def lint_ops(ops: Iterable[_Op], site: str) -> List[Finding]:
    """Lint one recorded op sequence (as returned by :func:`record_ops`)."""
    out: List[Finding] = []
    for op in ops:
        in_f = [dt for dt, _ in op.ins if dt.is_floating_point]
        out_f = [dt for dt, _ in op.outs if dt.is_floating_point]
        if op.name in _SYNC_OPS:
            out.append(Finding(
                "error", site, "host-callback",
                f"aten.{op.name} inside an apply path — a host sync that "
                f"stalls the card's queue each call"))
        elif op.name in _COPY_OPS and any(d.type != "cpu"
                                          for _, d in op.ins) and \
                any(d.type == "cpu" for _, d in op.outs):
            out.append(Finding(
                "error", site, "host-callback",
                f"aten.{op.name} copies a device tensor to the CPU inside "
                f"an apply path — a host round trip each call"))
        if torch.float64 in in_f and any(
                _FLOAT_WIDTH.get(dt, 8) < 8 for dt in out_f):
            narrow = sorted({str(dt).removeprefix("torch.") for dt in out_f
                             if _FLOAT_WIDTH.get(dt, 8) < 8})
            out.append(Finding(
                "error", site, "dtype-downcast",
                f"aten.{op.name}: float64 input narrowed to "
                f"{', '.join(narrow)}"))
        if op.name in _ACCUM_OPS and torch.bfloat16 in in_f and \
                torch.bfloat16 in out_f:
            out.append(Finding(
                "warning", site, "bf16-accum",
                f"aten.{op.name} over bf16 operands accumulates in bf16; "
                f"promote the accumulator to fp32 (bf16 carries ~8 "
                f"significand bits)"))
    return out


# ---------------------------------------------------------------------------
# sweep every registered apply path
# ---------------------------------------------------------------------------

def _probe_matrix(n: int = 64, density: float = 0.12, seed: int = 0):
    """The reference's probe matrix (``jaxpr_lint._probe_matrix``)."""
    from ..core.matrices import from_coo

    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density) * rng.random((n, n))
    np.fill_diagonal(dense, 1.0)
    rows, cols = np.nonzero(dense)
    return from_coo(n, rows, cols, dense[rows, cols])


def registered_paths(formats: Optional[List[str]] = None,
                     dtypes=(torch.float32, torch.bfloat16, torch.float64),
                     ks=(1, 4)):
    """Yield ``(site, thunk)`` pairs; each thunk runs one apply of a
    registered format on the probe matrix on the CPU."""
    from ..autotune.registry import available_formats, build_format, \
        get_format

    m = _probe_matrix()
    rng = np.random.default_rng(1)
    for fmt in (formats or available_formats()):
        spec = get_format(fmt)
        for dt in dtypes:
            dt_name = str(dt).removeprefix("torch.")
            obj = build_format(fmt, m, dt, {}, device="cpu")
            for k in ks:
                shape = (m.n,) if k == 1 else (m.n, k)
                x = torch.as_tensor(rng.standard_normal(shape), dtype=dt)
                yield (f"{fmt}:apply:{dt_name}:k{k}",
                       lambda a=spec.apply, o=obj, x=x: a(o, x))
                if spec.permuted is not None:
                    shape = (obj.n_pad,) if k == 1 else (obj.n_pad, k)
                    xp = torch.as_tensor(rng.standard_normal(shape),
                                         dtype=dt)
                    yield (f"{fmt}:permuted:{dt_name}:k{k}",
                           lambda a=spec.permuted, o=obj, x=xp: a(o, x))


def run_dispatch_lint(formats: Optional[List[str]] = None) -> List[Finding]:
    """Run + lint every registered apply path."""
    out: List[Finding] = []
    for site, thunk in registered_paths(formats):
        try:
            ops = record_ops(thunk)
        except Exception as e:  # noqa: BLE001 — any failure to run is
            # itself the reportable defect; the finding carries the cause
            out.append(Finding("error", site, "trace-failure",
                               f"{type(e).__name__}: {e}"))
            continue
        out += lint_ops(ops, site)
    if formats is None:
        out += run_collective_lint()
    return out


# ---------------------------------------------------------------------------
# collective-axis: the sharded paths' collectives name the plan's group
# ---------------------------------------------------------------------------

def _gather_one(out, inp, *args, **kwargs):
    out.zero_()
    out[: inp.shape[0]] = inp


def _scatter_one(out, inp, *args, **kwargs):
    out.copy_(inp[: out.shape[0]])


def _gather_object_one(out, obj, *args, **kwargs):
    out[:] = [obj] * len(out)


def _no_op(*args, **kwargs):
    return None


# torch.distributed collectives, each with the local stand-in the recorder
# runs in its place (a one-rank view: enough for the apply to go on)
_COLLECTIVES = {
    "all_to_all_single": lambda out, inp, *a, **k: out.copy_(inp),
    "all_gather_single": _gather_one,
    "all_gather_into_tensor": _gather_one,
    "reduce_scatter_single": _scatter_one,
    "reduce_scatter_tensor": _scatter_one,
    "all_reduce": _no_op,
    "all_gather_object": _gather_object_one,
    "broadcast": _no_op,
}


def record_collectives(fn, *args) -> list:
    """Run ``fn(*args)`` with every ``torch.distributed`` collective of
    :data:`_COLLECTIVES` replaced by a recorder; returns ``[(name,
    group)]``, the group each call named (None: the default group)."""
    import torch.distributed as dist

    calls = []
    saved = {name: getattr(dist, name, None) for name in _COLLECTIVES}

    def recorder(name):
        def call(*args, group=None, **kwargs):
            calls.append((name, group))
            return _COLLECTIVES[name](*args, **kwargs)
        return call
    try:
        for name in _COLLECTIVES:
            setattr(dist, name, recorder(name))
        fn(*args)
    finally:
        for name, f in saved.items():
            if f is None:
                delattr(dist, name)
            else:
                setattr(dist, name, f)
    return calls


def lint_collectives(calls, group, site: str) -> List[Finding]:
    """Flag each recorded collective that does not name ``group`` (or, for
    a :class:`LintMesh`, one of the groups it handed out)."""
    allowed = (tuple(group.groups.values()) if isinstance(group, LintMesh)
               else (group,))
    return [Finding("error", site, "collective-axis",
                    f"{name} on {'the default group' if g is None else g!r}"
                    f", not a mesh-axis group")
            for name, g in calls if not any(g is a for a in allowed)]


class LintMesh(ShapeMesh):
    """A device-mesh stand-in: a :class:`ShapeMesh` with rank 0's
    coordinates and one sentinel group per set of axes."""

    def __init__(self, shape: dict):
        super().__init__(shape)
        self.groups: dict = {}

    def get_group(self, axes):
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.groups.setdefault(key, object())

    def get_coordinate(self):
        return [0] * len(self.axis_names)


def _moe_path(cfg, mesh):
    from ..models import moe as M
    from ..models import shard_ctx

    gen = torch.Generator("cpu").manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in M.init_moe(gen, cfg).items()}
    x = torch.randn((4, 8, cfg.d_model), generator=gen, requires_grad=True)
    shard_ctx.set_sharding_context(mesh, ("data",))
    try:
        y, aux = M.apply_moe(p, x, cfg)
        (y.sum() + aux).backward()
    finally:
        shard_ctx.clear_sharding_context()


def _mesh_step(cfg, mesh):
    from ..data import SyntheticTokenDataset
    from ..launch.sharding import local_block, param_specs
    from ..models import init_model
    from ..models.transformer import tree_map
    from ..train import OptimizerConfig, init_train_state
    from ..train.train_step import make_mesh_train_step

    params = init_model(0, cfg, device="cpu")
    specs = param_specs(params, mesh, cfg)
    local = tree_map(lambda t, s: local_block(t, s, mesh).clone(), params,
                     specs)
    step = make_mesh_train_step(cfg, OptimizerConfig(), mesh, specs=specs)
    batch = SyntheticTokenDataset(cfg.vocab_size, 8, 4,
                                  seed=0).train_inputs(0)
    step(init_train_state(local, cfg), batch)


def mesh_paths():
    """Yield ``(site, mesh, thunk)``: the mesh path's pieces on rank 0 of a
    (data=2, model=2) :class:`LintMesh`, on the CPU."""
    import dataclasses

    from ..configs import get_config

    for arch, tag in (("moonshot_v1_16b_a3b", "expert"),
                      ("grok_1_314b", "ffn")):
        mesh = LintMesh({"data": 2, "model": 2})
        cfg = get_config(arch, smoke=True)
        yield f"mesh:moe:{tag}", mesh, lambda c=cfg, m=mesh: _moe_path(c, m)
    for arch in ("llama3_2_1b", "moonshot_v1_16b_a3b", "grok_1_314b"):
        mesh = LintMesh({"data": 2, "model": 2})
        cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=True)
        yield (f"mesh:step:{arch}", mesh,
               lambda c=cfg, m=mesh: _mesh_step(c, m))


def sharded_paths(n_dev: int = 2):
    """Yield ``(site, group, thunk)``: each thunk runs one sharded path on
    rank 0's shard of the probe matrix over ``n_dev`` ranks (a sentinel
    object as its group), on the CPU."""
    from ..core.ehyb import build_ehyb
    from ..dist.halo import build_halo_plan
    from ..dist.operator import (ShardedOperator, _shards_from_ehyb,
                                 sharded_apply, sharded_apply_permuted)

    group = object()
    e = build_ehyb(_probe_matrix(), n_parts=4, vec_size=16)
    hp = build_halo_plan(e, n_dev)
    obj, lay = _shards_from_ehyb(e, hp, torch.float32, torch.device("cpu"),
                                 0, group)
    eng = ShardedOperator(format="ehyb", obj=obj, mesh=None, axis="data",
                          n=e.n, nnz=e.nnz, plan=hp, host_ehyb=e,
                          dtype=torch.float32, layout=lay)
    rng = np.random.default_rng(2)
    for k in (1, 4):
        shape = (e.n,) if k == 1 else (e.n, k)
        x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
        xl = torch.as_tensor(rng.standard_normal(
            (obj.local_size,) + shape[1:]), dtype=torch.float32)
        yield (f"sharded:apply:k{k}", group,
               lambda x=x: sharded_apply(obj, x))
        yield (f"sharded:permuted:k{k}", group,
               lambda x=xl: sharded_apply_permuted(obj, x))
    b = torch.as_tensor(rng.standard_normal(obj.local_size),
                        dtype=torch.float32)
    for method in ("cg", "bicgstab"):
        yield (f"sharded:solve:{method}", group,
               lambda m=method: eng.solver_runner(m)(obj, b, None, None,
                                                     1e-6, 3))


def run_collective_lint(n_dev: int = 2) -> List[Finding]:
    """Run and lint every sharded path's and the mesh path's
    collectives."""
    import itertools

    out: List[Finding] = []
    for site, group, thunk in itertools.chain(sharded_paths(n_dev),
                                              mesh_paths()):
        try:
            calls = record_collectives(thunk)
        except Exception as e:  # noqa: BLE001 — any failure to run is
            # itself the reportable defect; the finding carries the cause
            out.append(Finding("error", site, "trace-failure",
                               f"{type(e).__name__}: {e}"))
            continue
        if not calls:
            out.append(Finding("error", site, "collective-axis",
                               "a sharded path made no collective"))
        out += lint_collectives(calls, group, site)
    return out

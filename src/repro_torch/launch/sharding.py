"""Sharding rules: a spec per parameter/state leaf → DTensor placements.

The port of ``repro.launch.sharding``.  The rule tables are the
reference's, verbatim; each spec function returns, per leaf, a tuple equal
entry by entry to the reference's ``PartitionSpec`` (None, an axis name, or
a tuple of names), and takes a ``DeviceMesh`` or a ``launch.mesh.ShapeMesh``.

Strategy (the reference's):
* TP (`model` axis): attention fused-head dims, d_ff, experts (EP), vocab.
* FSDP (`data` [+ `pod`] axes): the other large dim of every matrix when
  ``cfg.fsdp`` — parameters *and* Adam moments shard identically (ZeRO).
* DP: batch over (`pod`, `data`).
* Context parallel: long-context decode shards the KV-cache sequence dim
  over `data` when the batch is too small to.

Every rule passes through a divisibility check — a dim that doesn't divide
the axis product falls back (KV-heads → head_dim → replicate), so one rule
table covers all 10 architectures.

How the port computes on these shardings differs from the reference's,
which hands the whole step to GSPMD: eager PyTorch has no whole-step
partitioner.  The state's leaves are ``DTensor``s placed by these specs
(:func:`distribute_state`); the train step splits the global batch over
:func:`dp_axes` at its entry (:func:`make_shard_act`, the port's form of
the reference's activation constraint), all-gathers each unit's
parameters just before the unit runs, and reduces each gradient back to
its leaf's spec (``train.train_step``).  The `model` axis splits the
compute of the train step and of the mesh prefill and decode
(``models.transformer.prefill(..., mesh=)``) as GSPMD splits the
reference's: :func:`tp_layout` keeps each leaf's `model` shard where it
is aligned with what its layer splits, by the kind of block that holds
it (attention on heads, MLP and experts, Mamba on d_inner, RWKV's time
mix on heads and channel mix on d_ff, the vocab), and the layers split
their matmuls on it.  ``long_500k``'s decode state splits its caches'
sequence over `data` (:func:`state_specs` ``context_parallel``), and
the decode merges the blocks' softmax over it.
``act_sharding="sp"`` (sequence-parallel activations, Megatron's
explicit form of the reference's constraint) splits the residual
stream's sequence over `model` between blocks in the train step and the
mesh prefill (:func:`seq_axes`, set as ``shard_ctx``'s ``seq``): each
block gathers the sequence at entry and reduce-scatters its output.
"""

from __future__ import annotations

import math

import torch

from ..models.shard_ctx import (axis_names, axis_sizes, group_index,
                                group_size, spec_axes)
from .mesh import axis_size, batch_axes

# logical axes:  "tp" → model;  "fsdp" → (pod,)data;  "ep" → model (expert)
# Rules keyed by parameter leaf name; value = logical axis per dim of the
# UNSTACKED parameter (a leading scan/stack dim is auto-prepended None).
PARAM_RULES = {
    # embeddings / head
    "embedding": ("tp", "fsdp"),
    "pos_embedding": (None, None),
    "w_head": ("fsdp", "tp"),
    # norms
    "scale": (None,), "bias": (None,),
    "q_norm": (None,), "k_norm": (None,),
    # attention
    "w_q": ("fsdp", "tp"), "w_k": ("fsdp", "tp"), "w_v": ("fsdp", "tp"),
    "w_o": ("tp", "fsdp"),
    # dense mlp
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp"),
    # moe (expert sharding variant; "ffn" variant handled in code)
    "router": ("fsdp", None),
    "we_gate": ("ep", "fsdp", None), "we_up": ("ep", "fsdp", None),
    "we_down": ("ep", None, "fsdp"),
    # mamba
    "in_proj": ("fsdp", "tp"), "conv_w": (None, "tp"), "conv_b": ("tp",),
    "x_proj": ("tp", None), "dt_proj": (None, "tp"), "dt_bias": ("tp",),
    "A_log": ("tp", None), "D": ("tp",), "out_proj": ("tp", "fsdp"),
    # rwkv time mix
    "mu_x": (None,), "mu_rwkvg": (None, None),
    "lora_a": ("fsdp", None), "lora_b": (None, None, None),
    "w_r": ("fsdp", "tp"), "w_g": ("fsdp", "tp"),
    "decay_base": (None,), "decay_a": ("fsdp", None), "decay_b": (None, None),
    "bonus_u": ("tp", None), "ln_x": (None,),
    # rwkv channel mix
    "mu_k": (None,), "mu_r": (None,),
}

# FFN-sharded MoE (grok: E=8 < |model|): replicate experts, TP inside expert.
PARAM_RULES_MOE_FFN = {
    "we_gate": (None, "fsdp", "tp"), "we_up": (None, "fsdp", "tp"),
    "we_down": (None, "tp", "fsdp"),
}

STATE_RULES = {
    # KV caches (B, S, Hkv, dh): batch → data; heads → model (fallback dh)
    "k": ("batch", "ctx", "tp_heads", "tp_dh"),
    "v": ("batch", "ctx", "tp_heads", "tp_dh"),
    "ck": ("batch", "ctx", "tp_heads", "tp_dh"),
    "cv": ("batch", "ctx", "tp_heads", "tp_dh"),
    # mamba (B, dc-1, di) / (B, di, N)
    "conv": ("batch", None, "tp"),
    "ssm": ("batch", "tp", None),
    # rwkv (B,H,hs,hs) / (B,1,d)
    "wkv": ("batch", "tp", None, None),
    "x_prev_tm": ("batch", None, None),
    "x_prev_cm": ("batch", None, None),
}

MOE_EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def _leaf_name(path) -> str:
    """The last string key of a leaf's path (a tuple of keys)."""
    for k in reversed(tuple(path)):
        if isinstance(k, str):
            return k
    return ""


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _entry(axes):
    """One spec entry as a ``PartitionSpec`` holds it: None, an axis name,
    or a tuple of two or more names."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *leaves at the same path of rest)`` over a tree of
    dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def dp_axes(mesh, cfg) -> tuple:
    """Axes that shard batch-like dims: (pod,)data, plus model when the
    config opts into pure-DP (dp_over_model)."""
    axes = batch_axes(mesh)
    if getattr(cfg, "dp_over_model", False):
        axes = axes + ("model",)
    return axes


def tp_axes(mesh, cfg) -> tuple:
    """The axes the layers split their matmuls over (the context's
    ``tp``): `model`, unless the mesh has none or the config puts the
    batch on it (dp_over_model)."""
    if "model" not in axis_names(mesh) or getattr(cfg, "dp_over_model",
                                                  False):
        return ()
    return ("model",)


def _resolve(logical, mesh, cfg):
    if logical is None:
        return None
    if logical in ("tp", "ep"):
        return None if getattr(cfg, "dp_over_model", False) else "model"
    if logical == "fsdp":
        return dp_axes(mesh, cfg) if cfg.fsdp else None
    raise ValueError(logical)


def _spec_for(shape, dims_logical, mesh, cfg) -> tuple:
    """A spec with divisibility fallbacks."""
    ndim = len(shape)
    rule = list(dims_logical)
    # auto-prepend Nones for stacked leading dims (the unit stack, rwkv
    # 5-dim packs, etc.)
    while len(rule) < ndim:
        rule.insert(0, None)
    rule = rule[-ndim:] if len(rule) > ndim else rule
    spec = []
    for size, logical in zip(shape, rule):
        axes = _resolve(logical, mesh, cfg)
        if axes is None:
            spec.append(None)
            continue
        spec.append(_entry(axes) if size % axis_size(mesh, axes) == 0
                    else None)
    return tuple(spec)


def _param_rules(cfg) -> dict:
    rules = dict(PARAM_RULES)
    if cfg.n_experts and cfg.moe_sharding == "ffn":
        rules.update(PARAM_RULES_MOE_FFN)
    return rules


def param_specs(params_tree, mesh, cfg):
    """A spec for every leaf of ``params_tree`` (nested dicts of tensors,
    fake tensors or shapes)."""
    rules = _param_rules(cfg)

    def one(path, leaf):
        shape = _shape(leaf)
        # rwkv shares names with attention (w_r/w_k/w_v used in both tables
        # — same rule); unknown names replicate
        rule = rules.get(_leaf_name(path), tuple(None for _ in shape))
        return _spec_for(shape, rule, mesh, cfg)

    return _map_with_path(one, params_tree)


def train_state_specs(train_state, mesh, cfg):
    """TrainState(params, OptState(m, v, step), step): moments shard like
    params (ZeRO); the steps are replicated."""
    from ..train.optimizer import OptState
    from ..train.train_step import TrainState

    return TrainState(
        params=param_specs(train_state.params, mesh, cfg),
        opt=OptState(m=param_specs(train_state.opt.m, mesh, cfg),
                     v=param_specs(train_state.opt.v, mesh, cfg), step=()),
        step=())


def state_specs(state_tree, mesh, cfg, *, global_batch: int,
                context_parallel: bool = False):
    """Decode-state specs.  ``context_parallel`` shards the cache sequence
    dim over `data` (long_500k, batch=1)."""
    sizes = axis_sizes(mesh)
    b_axes = dp_axes(mesh, cfg)
    b_ok = global_batch % axis_size(mesh, b_axes) == 0

    def one(path, leaf):
        rule = STATE_RULES.get(_leaf_name(path))
        if rule is None:
            return ()
        body = _shape(leaf)[1:]                   # (n_units, B, ...)
        spec = [None]                             # stacked units dim
        used_tp = False
        for size, logical in zip(body, rule):
            if logical == "batch":
                spec.append(_entry(b_axes) if b_ok and size % axis_size(
                    mesh, b_axes) == 0 else None)
            elif logical == "ctx":
                spec.append("data" if context_parallel
                            and size % sizes["data"] == 0 else None)
            elif logical == "tp_heads":
                used_tp = size % sizes["model"] == 0
                spec.append("model" if used_tp else None)
            elif logical == "tp_dh":
                spec.append("model" if not used_tp
                            and size % sizes["model"] == 0 else None)
            elif logical == "tp":
                spec.append("model" if size % sizes["model"] == 0 else None)
            else:
                spec.append(None)
        return tuple(spec)

    return _map_with_path(one, state_tree)


def batch_specs(batch_tree, mesh, *, global_batch: int, cfg=None):
    """The batch's leading dim over the DP axes when the global batch
    divides them, else replicated."""
    b_axes = dp_axes(mesh, cfg) if cfg is not None else batch_axes(mesh)
    ok = global_batch % axis_size(mesh, b_axes) == 0
    return _map_with_path(
        lambda _, leaf: (_entry(b_axes) if ok else None,)
        + (None,) * (len(_shape(leaf)) - 1), batch_tree)


# ---------------------------------------------------------------------------
# placements: specs as DTensor placements
# ---------------------------------------------------------------------------

def placements(spec, mesh) -> tuple:
    """The ``DTensor`` placements of one spec on ``mesh``: ``Shard(d)`` on
    each mesh dim that shards tensor dim ``d``, ``Replicate()`` elsewhere.
    A dim sharded over several axes (``("pod", "data")``) is ``Shard(d)``
    on each, which DTensor splits in mesh order — jax's major-to-minor."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(leaf) -> tuple:
    """The spec of a ``DTensor`` (its placements read back), or ``()``
    for a plain tensor (replicated)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(leaf, DTensor):
        return ()
    names = leaf.device_mesh.mesh_dim_names
    spec = [[] for _ in range(leaf.ndim)]
    for name, p in zip(names, leaf.placements):
        if isinstance(p, Shard):
            spec[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in spec)


def _placement_tree(specs, mesh):
    if isinstance(specs, dict):
        return {k: _placement_tree(v, mesh) for k, v in specs.items()}
    if hasattr(specs, "_fields"):                 # a NamedTuple of specs
        return type(specs)(*(_placement_tree(getattr(specs, f), mesh)
                             for f in specs._fields))
    return placements(specs, mesh)


def param_shardings(params_tree, mesh, cfg):
    """Placement tree matching ``params_tree``."""
    return _placement_tree(param_specs(params_tree, mesh, cfg), mesh)


def train_state_shardings(train_state, mesh, cfg):
    return _placement_tree(train_state_specs(train_state, mesh, cfg), mesh)


def state_shardings(state_tree, mesh, cfg, *, global_batch: int,
                    context_parallel: bool = False):
    return _placement_tree(state_specs(
        state_tree, mesh, cfg, global_batch=global_batch,
        context_parallel=context_parallel), mesh)


def batch_shardings(batch_tree, mesh, *, global_batch: int, cfg=None):
    return _placement_tree(batch_specs(batch_tree, mesh,
                                       global_batch=global_batch, cfg=cfg),
                           mesh)


# ---------------------------------------------------------------------------
# the state on a mesh
# ---------------------------------------------------------------------------

def local_block(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The rank's block of ``full`` under ``spec`` (a view)."""
    out = full
    for d, entry in enumerate(spec):
        if entry is not None:
            n = group_size(mesh, entry)
            rows = full.shape[d] // n
            out = out.narrow(d, group_index(mesh, entry) * rows, rows)
    return out


def local_size_bytes(shape, spec, mesh, itemsize: int) -> int:
    """Bytes of one rank's block of a ``shape`` leaf under ``spec``."""
    n = math.prod(shape)
    for entry in spec:
        if entry is not None:
            n //= group_size(mesh, entry)
    return n * itemsize


def _dtensor(local: torch.Tensor, spec, mesh, shape):
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def shard_leaf(full: torch.Tensor, spec, mesh, device=None):
    """A ``DTensor`` on ``mesh`` holding the rank's block of ``full`` (a
    copy, on ``device``, default ``full``'s: ``full`` can be freed); no
    collective."""
    local = local_block(full, spec, mesh).to(device or full.device,
                                             copy=True)
    return _dtensor(local, spec, mesh, tuple(full.shape))


def distribute_params(params, mesh, cfg):
    """``params`` (full, the same on every rank) as ``DTensor``s placed by
    :func:`param_specs`."""
    def tree(t, s):
        if isinstance(t, dict):
            return {k: tree(t[k], s[k]) for k in t}
        return shard_leaf(t, s, mesh)

    return tree(params, param_specs(params, mesh, cfg))


def distribute_state(state, mesh, cfg):
    """The sharded form of a full ``TrainState`` (every rank holding the
    same one, e.g. from ``init_train_state`` with one seed or
    ``convert.train_state``): params and moments as ``DTensor``s placed by
    :func:`train_state_specs`, the steps as they are."""
    from ..train.optimizer import OptState
    from ..train.train_step import TrainState

    return TrainState(
        params=distribute_params(state.params, mesh, cfg),
        opt=OptState(m=distribute_params(state.opt.m, mesh, cfg),
                     v=distribute_params(state.opt.v, mesh, cfg),
                     step=state.opt.step),
        step=state.step)


def full_tensor(leaf) -> torch.Tensor:
    """A ``DTensor`` leaf all-gathered into a plain tensor on every rank of
    its mesh (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    from ..models.shard_ctx import _all_gather

    if not isinstance(leaf, DTensor):
        return leaf
    out = leaf.to_local()
    for d, entry in enumerate(spec_of(leaf)):
        if entry is not None:
            out = _all_gather(out, d, leaf.device_mesh, entry)
    return out.contiguous()


def gather_state(tree):
    """``tree`` (dicts and NamedTuples) with every ``DTensor`` leaf
    gathered into a full tensor — every rank of its mesh must call it."""
    if isinstance(tree, dict):
        return {k: gather_state(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(gather_state(getattr(tree, f))
                            for f in tree._fields))
    return full_tensor(tree)


# what a layer computes with on its `model` shard (tensor-parallel
# compute), by the kind of block that holds the leaf: each leaf the layer
# splits, and the config dim that must divide `model` for the split (None:
# any shard will do).  ``w_k``/``w_v`` follow the query heads: the rank's
# kv heads where ``n_kv_heads`` divides `model` too, else the rank's block
# of columns, whose products the layer gathers (``attention._project_qkv``).
# Mamba splits on d_inner (``in_proj``'s column blocks re-laid out by one
# all-to-all, ``mamba._own_x_and_z``), RWKV's time mix on heads, its
# channel mix on d_ff (``w_k``) and d (``w_r``, ``w_v``: attention's rule
# by name, the output's columns)
_MAMBA = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
          "A_log", "D", "out_proj")
TP_SPLIT = {
    "attn": {"w_q": "n_heads", "w_o": "n_heads", "w_k": "n_heads",
             "w_v": "n_heads"},
    "mlp": {"w_gate": None, "w_up": None, "w_down": None},
    "moe": {"we_gate": None, "we_up": None, "we_down": None},
    "mamba": dict.fromkeys(_MAMBA, "mamba_d_inner"),
    "rwkv": dict.fromkeys(("w_r", "w_k", "w_v", "w_g", "w_o", "bonus_u"),
                          "rwkv_n_heads"),
    "rwkv_cm": {"w_k": "d_ff", "w_r": "d_model", "w_v": "d_model"},
    "embed": {"embedding": None},
    "head": {"w_head": None},
}
# whole leaves a split block computes with on the rank's part only (an
# attention block's query heads, an RWKV time mix's channels): their
# gradients are each rank's part
_TP_PARTIAL = {"attn": ("q_norm", "k_norm"),
               "rwkv": ("decay_base", "decay_b", "ln_x")}
# blocks whose layer reads one layout for all their split leaves: each
# keeps all of them on `model` or none
_ALL_OR_NONE = ("mamba", "rwkv", "rwkv_cm")


def _block_kind(path, cfg):
    """The kind of layer that computes with the leaf at ``path`` (a key of
    :data:`TP_SPLIT`: ``attn``, ``mlp``, ``moe``, ``mamba``, ``rwkv``,
    ``rwkv_cm``, ``embed``, ``head``), or None (norms, and leaves outside
    a block)."""
    from ..models.transformer import _ATTN_KINDS, UNIT_KEYS

    if path[0] in ("embed", "head"):
        return path[0]
    if path[0] not in UNIT_KEYS or len(path) < 4:
        return None
    pattern = cfg.unit_pattern if path[0] == "units" else \
        cfg.enc_unit_pattern
    mixer, ffn = pattern[int(path[1][1:])]
    kind = {"mixer": mixer, "cross": "attn", "ffn": ffn}.get(path[2])
    return "attn" if kind in _ATTN_KINDS else kind


def tp_layout(specs, mesh, cfg):
    """Per leaf of ``specs`` (the params' specs, a unit stack's with its
    leading dim), ``(keep, partial)``: ``keep`` is ``("model",)`` where the
    layer computes with the rank's `model` shard (its block's kind splits
    the leaf, the dim the split needs divides `model`, and the spec shards
    the leaf over it), else ``()``; ``partial`` is ``("model",)`` where the
    leaf is whole but the rank computes with it on its own part only — an
    attention block's q_norm/k_norm on split query heads, an RWKV time
    mix's ``decay_base``/``decay_b``/``ln_x`` on split heads — so that its
    gradient must be summed over `model` (never where `model` has one
    rank).  Both are ``()`` where the layers split nothing
    (:func:`tp_axes` empty: no `model` axis, or the batch on it).  One
    table (:data:`TP_SPLIT`) for the mesh train step and the mesh prefill
    and decode.  Raises where the query heads split but the spec leaves
    ``w_k``/``w_v`` whole (no config meets it: a head_dim of 16 or more
    on at most 16 `model` ranks), and where a Mamba or RWKV block would
    keep some of its split leaves and not others (its layer reads one
    layout for all)."""
    on = bool(tp_axes(mesh, cfg))
    tp = axis_size(mesh, "model") if on else 1
    split = {"attn": tp > 1 and cfg.n_heads % tp == 0,
             "rwkv": tp > 1 and cfg.rwkv_n_heads % tp == 0}

    def one(path, spec):
        kind, name = _block_kind(path, cfg), _leaf_name(path)
        unit = TP_SPLIT.get(kind, {}).get(name, 0)
        aligned = unit is None or (unit and getattr(cfg, unit) % tp == 0)
        keep = ("model",) if on and aligned and \
            "model" in spec_axes(spec) else ()
        if split["attn"] and kind == "attn" and name in ("w_k", "w_v") \
                and not keep:
            raise ValueError(
                f"{'/'.join(path)}: {cfg.n_heads} query heads split over "
                f"{tp} `model` ranks, but the spec {spec} leaves the kv "
                f"projection whole")
        partial = ("model",) if split.get(kind) and not keep and \
            name in _TP_PARTIAL.get(kind, ()) else ()
        return keep, partial

    layout = _map_with_path(one, specs)
    _check_all_or_none(layout, cfg)
    return layout


def _check_all_or_none(layout, cfg) -> None:
    """Raises where a block of :data:`_ALL_OR_NONE` keeps some of its
    :data:`TP_SPLIT` leaves on `model` and not others."""
    from ..models.transformer import UNIT_KEYS

    for key in UNIT_KEYS:
        for b, block in layout.get(key, {}).items():
            for part, leaves in block.items():
                kind = _block_kind((key, b, part, ""), cfg)
                if kind not in _ALL_OR_NONE:
                    continue
                kept = {n: bool(leaves[n][0]) for n in TP_SPLIT[kind]}
                if len(set(kept.values())) > 1:
                    raise ValueError(
                        f"{key}/{b}/{part}: a {kind} block keeps only "
                        f"some of its split leaves on `model` ({kept}); "
                        f"its layer splits all or none")


def serve_gather_rules(specs, mesh, cfg):
    """Per leaf of ``specs`` (the params' specs), the ``(spec, partial,
    keep)`` that ``shard_ctx.gather_param`` takes in the mesh prefill and
    decode: every axis is gathered (the fsdp axes per unit, as the train
    step gathers them) but `model`, which stays sharded where
    :func:`tp_layout` keeps it — attention where ``n_heads`` divides
    `model` (``w_k``/``w_v`` on kv heads where ``n_kv_heads`` does too,
    else on columns), the MLP on d_ff, the embedding and head on the
    vocab, the experts on E (``moe_sharding="expert"``) or on d_ff
    (``"ffn"``), Mamba on d_inner, RWKV's time mix on heads and its
    channel mix on d_ff and d.  Forward only: no gradient is summed."""
    from ..models.transformer import UNIT_KEYS

    def one(path, spec, layout):
        if path[0] in UNIT_KEYS:
            spec = spec[1:]                   # one unit of the stack
        return spec, (), layout[0]

    return _map_with_path(one, specs, tp_layout(specs, mesh, cfg))


def seq_axes(mesh, cfg, seq_len: int) -> tuple:
    """The axes the residual stream of ``seq_len`` tokens splits its
    sequence over between blocks (``shard_ctx``'s ``seq``): `model` under
    ``act_sharding="sp"`` where it divides the sequence and has more than
    one rank, as the reference's :func:`make_shard_act` constrains it;
    none under ``dp_over_model`` (the batch is on `model`), for an
    encoder-decoder (its encoder's activations stay whole), or where
    `model` does not divide ``seq_len`` (a decode step's one token)."""
    tp = tp_axes(mesh, cfg)
    if cfg.act_sharding != "sp" or not tp or \
            cfg.family == "encdec":
        return ()
    n = axis_size(mesh, tp)
    return tp if n > 1 and seq_len % n == 0 else ()


def make_shard_act(mesh, cfg):
    """The batch split at the train step's entry: ``shard(x)`` is the
    rank's block of ``x``'s leading (batch) dim over :func:`dp_axes`, or
    ``x`` itself when the dim does not divide them (the reference's
    ``batch_shardings`` ``ok`` flag).  The reference's constraint's other
    half, the sequence over `model` under ``act_sharding="sp"``, is
    :func:`seq_axes`: the step and the mesh prefill set it as the
    context's ``seq``, and each block leaves its output on the rank's
    block of the sequence (``shard_ctx.leave_block``)."""
    b_axes = dp_axes(mesh, cfg)
    n = axis_size(mesh, b_axes)

    def shard(x):
        if x.ndim == 0 or x.shape[0] % n:
            return x
        return local_block(x, (b_axes,), mesh)

    return shard


__all__ = ["PARAM_RULES", "PARAM_RULES_MOE_FFN", "STATE_RULES", "dp_axes",
           "tp_axes",
           "param_specs", "train_state_specs", "state_specs", "batch_specs",
           "placements", "spec_of", "param_shardings",
           "train_state_shardings", "state_shardings", "batch_shardings",
           "local_block", "local_size_bytes", "shard_leaf",
           "TP_SPLIT", "tp_layout", "serve_gather_rules",
           "distribute_params", "distribute_state", "full_tensor", "gather_state",
           "make_shard_act", "seq_axes"]

"""Top-k MoE with capacity dispatch (GShard semantics).

The port of ``repro.models.moe``, its single-device path: routing, a
stable sort of the (token, choice) pairs by expert, a compact
``(E, cap, d)`` buffer, the experts as batched matmuls, and a weighted
scatter back to token order.  Capacity overflow tokens are dropped
(standard GShard top-k) and a load-balancing auxiliary loss (Switch) is
returned.

Two points keep the port's routing the reference's:

* ``jax.lax.top_k`` breaks ties to the lower index; ``torch.topk`` on CUDA
  promises no order, so the top k come from a stable descending argsort;
* the packing sorts with ``argsort(stable=True)``, so tokens keep their
  order inside an expert and the same ones overflow.

The reference's ``.at[].add`` scatters are ``index_add``: on CUDA that
accumulates with atomics, so a token's k contributions may sum in another
order (not bit-reproducible; two contributions onto zero are).

Two dispatch paths, as the reference's:

* **Distributed path** — used whenever a sharding context is set
  (``models.shard_ctx``; the mesh train step sets one).  Routing, sort and
  the capacity buffer run per rank on its slice of the token stream (the
  axes :func:`_token_split_axes` picks, the reference's per-shard
  ``shard_map``), producing a compact ``(E, C_dev, d)`` buffer; when the
  experts shard over `model`, one ``all_to_all_single`` over the model
  group moves expert groups between model peers (``(E, cap, d) →
  (E/tp, tp·cap, d)``), the rank's experts run, and the reverse exchange
  brings their outputs home.  The tokens are then gathered back over the
  split axes that the dense layers replicate.  Each collective runs in
  autograd as ``shard_ctx``'s Megatron pairs do, so no gradient is summed
  over ranks that only repeat work.
* **Single-device path** — without a context.  Same math, same capacity
  semantics.

``moe_sharding="ffn"`` (grok-1: E=8 < TP axis 16) keeps the experts whole
on every model peer and splits the tokens over the data axes only.  Under
a tensor-parallel context (``shard_ctx.tp_split``: the mesh train step,
prefill and decode) two layouts follow the reference's GSPMD placement of the
buffer:

* experts handed as the rank's block of d_ff (grok's ffn mode, the
  leaves' ``model`` split kept) run the rank's columns then rows, and the
  combined output is summed over `model` (tensor parallelism inside each
  expert); the buffer and the gate weights are read through
  ``shard_ctx.copy_to``, so their gradients — each rank's part, from its
  block of d_ff — are summed over `model`, and the router's and the
  input's are every rank's alike;
* experts handed as the rank's block of E, with no all-to-all (tokens not
  split over `model`: 128 decode tokens over 16 data ranks), run on the
  rank's slice of the buffer, which every model peer holds alike, and the
  outputs are gathered over `model` — the reference's relayout of the
  buffer onto ``("model", "batch", None)``.

The mesh train step (a tensor-parallel context too) runs these layouts
as the mesh prefill and decode do, each gradient summed as above.

Under a sequence-parallel context (``shard_ctx.seq_split``: the rank's
input is its block of the sequence) the experts' all-to-all takes the
rank's tokens as they are where the token split runs over the batch's
axes and then `model` (jamba's ``"expert"`` mode): the block is the
rank's slice of the token stream, so nothing is gathered or re-split.
Otherwise (grok's ``"ffn"`` mode) the sequence is gathered at entry, as
the MLP's is, and the d_ff split's partial output reduce-scattered back
onto the blocks in place of its sum.  The aux loss counts the whole
batch's tokens either way.  With capacity drops a rank's slice of the
stream is its rows' block of the sequence, where the reference's
partitioner hands it a contiguous run of the flattened batch: the same
per-shard capacity over other tokens.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import shard_ctx
from .layers import _dense_init, _gelu, cdtype, pdtype


def init_moe(gen: torch.Generator, cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = pdtype(cfg)
    scale = 1.0 / np.sqrt(d)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=dt, device=gen.device)

    return {
        "router": _dense_init(gen, (d, e), dt),
        "we_gate": normal((e, d, f)) * scale,
        "we_up": normal((e, d, f)) * scale,
        "we_down": normal((e, f, d)) / np.sqrt(f),
    }


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, ties to the
    lower index.  Returns (values, indices)."""
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return probs.gather(-1, idx), idx


def expert_counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    """Tokens an expert: ``bincount(idx, minlength=e)`` for indices below
    ``e`` (the reference's ``jnp.bincount(length=e)``), as a scatter into
    ``e`` slots — a static shape, so no host sync and no data-dependent
    output under ``FakeTensorMode``."""
    return torch.zeros(e, dtype=torch.int64, device=idx.device).index_add_(
        0, idx.long(), torch.ones_like(idx, dtype=torch.int64))


def _route_and_pack(xt: torch.Tensor, router: torch.Tensor, cfg, cap: int):
    """Routing + sort-based packing.  xt: (T, d).  Returns (buf (E, cap, d),
    slot, tok_of, w, (me_sum, ce_sum))."""
    dt = xt.dtype
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = (xt @ router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # Switch aux-loss statistics (sums; the caller normalizes)
    me_sum = probs.sum(dim=0)                                    # (E,)
    ce_sum = expert_counts(expert_idx[:, 0], e).float()

    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = expert_counts(sorted_e, e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=xt.device) - starts[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, e * cap))
    tok_of = order // k
    w = (gate_vals.reshape(-1)[order] * keep).to(dt)

    # one row a kept pair; the dropped pairs all land in the sink row e*cap
    buf = xt.new_zeros((e * cap + 1, d)).index_add(0, slot, xt[tok_of])
    return buf[:-1].reshape(e, cap, d), slot, tok_of, w, (me_sum, ce_sum)


def _combine(out_buf: torch.Tensor, slot, tok_of, w, t: int) -> torch.Tensor:
    """Scatter expert outputs back to token order."""
    e_cap = out_buf.shape[0] * out_buf.shape[1]
    out_flat = out_buf.reshape(e_cap, -1)
    gathered = out_flat[torch.clamp(slot, max=e_cap - 1)]
    y = out_flat.new_zeros((t, out_flat.shape[1]))
    return y.index_add(0, tok_of, gathered * w[:, None])


def _expert_ffn(p, buf: torch.Tensor, cfg) -> torch.Tensor:
    dt = buf.dtype
    gates = torch.bmm(buf, p["we_gate"].to(dt))        # (E, cap, f)
    ups = torch.bmm(buf, p["we_up"].to(dt))
    act = F.silu(gates) if cfg.act != "geglu" else _gelu(gates)
    return torch.bmm(act * ups, p["we_down"].to(dt))   # (E, cap, d)


def capacity(t: int, cfg) -> int:
    """Slots an expert, the reference's rounding: ⌈T·k/E·factor⌉ rounded
    up to a multiple of 8, at least 8."""
    cap = int(math.ceil(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def _apply_moe_local(p, x: torch.Tensor, cfg):
    dt = cdtype(cfg)
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    xt = x.reshape(t, d).to(dt)
    buf, slot, tok_of, w, (me_sum, ce_sum) = _route_and_pack(
        xt, p["router"], cfg, capacity(t, cfg))
    out_buf = _expert_ffn(p, buf, cfg)
    y = _combine(out_buf, slot, tok_of, w, t)
    aux = e * torch.sum((me_sum / t) * (ce_sum / t)) * cfg.router_aux_coef
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# distributed path (per-rank routing over the token stream)
# ---------------------------------------------------------------------------

def _token_split_axes(t, mesh, batch_axes_, include_model=True):
    """Largest set of mesh axes (DP axes first, then model) that divides T.

    FFN-sharded MoE (``include_model=False``) keeps tokens data-split only:
    every model peer needs every token, so splitting tokens over `model`
    would force a buffer re-gather."""
    sizes = shard_ctx.axis_sizes(mesh)
    axes = []
    n = 1
    cand = list(batch_axes_ or ()) + (["model"] if include_model else [])
    for a in cand:
        if a in axes:           # `model` already a batch axis (dp_over_model)
            continue
        size = sizes[a]
        if t % (n * size) == 0:
            axes.append(a)
            n *= size
    return tuple(axes), n


def moe_split(t: int, mesh, batch_axes_, cfg):
    """(split axes, n_split, use_a2a) of a MoE layer over ``t`` tokens (the
    whole batch's), the reference's choice: tokens split over
    :func:`_token_split_axes`; the all-to-all when the experts shard over
    `model` and the tokens were split over it too."""
    ep = cfg.moe_sharding == "expert"
    split, n_split = _token_split_axes(t, mesh, batch_axes_,
                                       include_model=ep)
    tp = shard_ctx.axis_sizes(mesh)["model"]
    use_a2a = ep and "model" in split and cfg.n_experts % tp == 0
    return split, n_split, use_a2a


def _apply_moe_dist(p, x, cfg, mesh, batch_axes_, split_in=()):
    """The distributed path.  ``x`` is this rank's block of the batch: the
    whole batch split over ``split_in`` (the axes the caller already split
    it over, a leading part of the token split; ``()`` when every rank
    holds all of it).  The expert leaves of ``p`` are either whole
    ``(E, d, f)`` or this rank's experts ``(E/tp, d, f)`` over `model`.
    Returns (y: x's shape, aux)."""
    y, aux, _ = _moe_dist(p, x, cfg, mesh, batch_axes_, split_in)
    return y, aux


def _moe_dist(p, x, cfg, mesh, batch_axes_, split_in=(), reduce=True):
    """:func:`_apply_moe_dist`'s (y, aux) and whether ``y`` is the rank's
    part of a sum over `model` (the d_ff split's, left unsummed when not
    ``reduce``)."""
    dt = cdtype(cfg)
    b, s, d = x.shape
    t = b * s * shard_ctx.group_size(mesh, split_in)
    e = cfg.n_experts
    split, n_split, use_a2a = moe_split(t, mesh, batch_axes_, cfg)
    if tuple(split[:len(split_in)]) != tuple(split_in):
        raise ValueError(f"the batch split {split_in} is not a leading part "
                         f"of the MoE token split {split}")
    extra = split[len(split_in):]
    t_dev = t // n_split
    cap_dev = capacity(t_dev, cfg)
    tp = shard_ctx.axis_sizes(mesh)["model"]

    xt = shard_ctx.scatter_to(x.reshape(b * s, d).to(dt), 0, mesh, extra)
    buf, slot, tok_of, w, (me, ce) = _route_and_pack(xt, p["router"], cfg,
                                                     cap_dev)
    me = shard_ctx.sum_over(me, mesh, split)
    ce = shard_ctx.reduce_sum(ce, mesh, split)
    experts = {k: p[k] for k in ("we_gate", "we_up", "we_down")}
    local = experts["we_gate"].shape[0] < e
    tp_ctx = shard_ctx.tp_split()
    f_split = tp_ctx is not None and \
        experts["we_gate"].shape[-1] < cfg.d_ff
    own = tp_ctx is not None and local and not use_a2a
    if own:                # the rank's experts on its slice of the buffer
        j = shard_ctx.group_index(mesh, "model")
        n_own = experts["we_gate"].shape[0]
        buf = shard_ctx.copy_to(buf, mesh, "model")  # every peer's grads
        buf = buf[j * n_own:(j + 1) * n_own]
    if f_split:            # each rank's d_ff block reads all of the buffer
        buf = shard_ctx.copy_to(buf, *tp_ctx)
        # and the gates weigh each rank's part of the outputs
        w = shard_ctx.copy_to(w, *tp_ctx)
    if use_a2a:
        if not local:                      # this rank's experts of all E
            j = shard_ctx.group_index(mesh, "model")
            experts = {k: v[j * (e // tp):(j + 1) * (e // tp)]
                       for k, v in experts.items()}
        # (E, cap, d) -> (E/tp, tp*cap, d): expert group j to model peer j
        buf = shard_ctx.all_to_all(buf, mesh, "model")
        buf = buf.reshape(tp, e // tp, cap_dev, d).transpose(0, 1).reshape(
            e // tp, tp * cap_dev, d)
    elif local and not own:                # the experts whole on every peer
        experts = {k: shard_ctx.gather_from(v, 0, mesh, "model")
                   for k, v in experts.items()}
    out_buf = _expert_ffn(experts, buf, cfg)
    if own:
        out_buf = shard_ctx.gather_from(out_buf, 0, mesh, "model")
    if use_a2a:   # reverse exchange: (E/tp, tp*cap, d) -> (E, cap, d)
        out_buf = out_buf.reshape(e // tp, tp, cap_dev, d).transpose(0, 1)
        out_buf = shard_ctx.all_to_all(out_buf, mesh, "model").reshape(
            e, cap_dev, d)
    y = _combine(out_buf, slot, tok_of, w, t_dev)
    if f_split and reduce:                 # the rows of the d_ff split
        y = shard_ctx.sum_over(y, *tp_ctx)
    y = shard_ctx.gather_from(y, 0, mesh, extra)
    aux = e * torch.sum((me / t) * (ce / t)) * cfg.router_aux_coef
    return y.reshape(b, s, d), aux, f_split and not reduce


def _apply_moe_seq(p, x, cfg, mesh, batch_axes_, split_in, seq_axes):
    """The distributed path on the rank's block ``x`` of the sequence (a
    sequence-parallel context): see the module docstring."""
    b, s, _ = x.shape
    on_seq = tuple(split_in) + tuple(seq_axes)
    t = b * s * shard_ctx.group_size(mesh, on_seq)
    split, _, use_a2a = moe_split(t, mesh, batch_axes_, cfg)
    if use_a2a and tuple(split[:len(on_seq)]) == on_seq:
        return _apply_moe_dist(p, x, cfg, mesh, batch_axes_, on_seq)
    y, aux, partial = _moe_dist(p, shard_ctx.enter_block(x, False), cfg,
                                mesh, batch_axes_, split_in, reduce=False)
    return shard_ctx.leave_block(y, partial), aux


def apply_moe(p, x: torch.Tensor, cfg):
    """x: (B, S, d) → (y: (B, S, d), aux_loss scalar fp32)."""
    mesh = shard_ctx._CTX["mesh"]
    if mesh is None:
        return _apply_moe_local(p, x, cfg)
    seq = shard_ctx.seq_split()
    if seq is not None:
        return _apply_moe_seq(p, x, cfg, mesh, shard_ctx._CTX["batch_axes"],
                              shard_ctx._CTX["split"], seq[1])
    return _apply_moe_dist(p, x, cfg, mesh, shard_ctx._CTX["batch_axes"],
                           shard_ctx._CTX["split"])


__all__ = ["init_moe", "apply_moe", "top_k", "expert_counts", "capacity",
           "moe_split"]

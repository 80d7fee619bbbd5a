"""Model assembly: a loop over units covering all ten assigned
architectures (dense GQA, MoE, local/global alternation, RWKV-6, Mamba
hybrid, encoder-decoder, early-fusion VLM).

The port of ``repro.models.transformer``.  A *unit* is the repeating group
of (mixer, ffn) blocks (``cfg.unit_pattern``); parameters and decode states
are stacked along a leading ``n_units`` axis, as the reference's are, and a
Python loop over that axis replaces its ``lax.scan`` (each stacked leaf is
unbound once, so the backward pass stacks the units' gradients in one
pass).  ``cfg.remat`` runs each unit in ``torch.utils.checkpoint`` when
grad mode is on — the reference's ``jax.checkpoint`` with
``nothing_saveable``: only the unit's inputs are kept, and its activations
are recomputed in the backward pass.

Three entry points:
  forward(params, batch, cfg)                      → (hidden, moe aux)
  prefill(params, batch, cfg, state)               → (hidden_last, state')
  decode_step(params, tokens, cfg, state, pos)     → (hidden, state')
The caller turns hidden states into logits or the loss
(``layers.logits_fn``, ``serve_logits``, ``layers.chunked_xent``).  No
entry point modifies the state it is given, but the mesh prefill and
decode.

On a mesh the train step hands ``forward`` the units' parameters as this
rank's shards and a ``gather(key, unit_params)`` callable (``key`` is
``"units"`` or ``"enc_units"``) that all-gathers one unit's leaves — over
every axis but the `model` shards its layers split on, under the step's
tensor-parallel context; it runs inside the checkpointed unit, so the
backward pass gathers again instead of keeping every unit's gathered
weights alive (where the reference passes ``shard_act`` to its scan
body).  Without it nothing changes.

**The mesh prefill and decode** (``prefill(..., mesh=, specs=)``,
``decode_step(..., mesh=, specs=)``) take this rank's shards of the
params and of the decode state — ``DTensor``s, or local shards with the
params' ``specs`` given (``launch.sharding.param_specs``; the state laid
out by ``state_specs``, whose specs ``state_specs=`` takes where the
state is local shards split over the sequence), the params best
prepared once by ``mesh_params`` — and the global tokens, of which the
rank takes its block of rows over the batch axes where the batch divides
them (else every rank of those axes runs every row).  Each unit's params
are gathered over every axis but `model` where the leaf's `model` shard
is aligned with its layer's split (``launch.sharding.serve_gather_rules``),
and the layers split their compute over `model` (``shard_ctx.tp_split``):
attention on heads or on head_dim, the MLP on d_ff, the embedding and
head on the vocab, Mamba on d_inner, RWKV's time mix on heads and its
channel mix on d_ff.  Where the caches split their sequence over `data`
(``long_500k``: ``state_specs(..., context_parallel=True)``) the decode
merges the blocks' softmax over `data` (``shard_ctx.ctx_split``).  The
caches and the Mamba and RWKV states are written in place into the state
handed in, as the reference donates it, and that same state is returned;
the hidden states returned are the rank's rows.  ``serve_logits(...,
mesh=)`` turns them into the rank's block of the vocab for every row (the
reference's out-spec ``P(None, None, "model")``).  Each unit runs through
``layers.region``, where the cost counter replays it.

**Sequence parallelism** (``cfg.act_sharding == "sp"``, the reference's
``make_shard_act`` constraint after every residual add): in the mesh
train step and prefill, where ``launch.sharding.seq_axes`` splits the
sequence over `model`, the residual stream between blocks is the rank's
block of it, ``(B_rank, S/|model|, d)`` — the embedding reduce-scatters
onto it, each block gathers the sequence at entry and reduce-scatters
(or slices) its output back, the norms and residual adds run on the
block, and the remat boundaries keep it.  ``forward`` then returns the
rank's block of the hidden states (``layers.head_input`` gathers them
for the head); the prefill's last hidden state comes from the last
block.  The decode (one token) never splits.  An encoder-decoder keeps
its activations whole (``seq_axes``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from . import attention as attn
from . import shard_ctx
from . import mamba as mamba_mod
from . import rwkv as rwkv_mod
from .layers import (apply_mlp, apply_norm, cdtype, embed_tokens,
                     init_embedding, init_lm_head, init_mlp, init_norm,
                     logits_fn, region, remat)
from .moe import apply_moe, init_moe

_ATTN_KINDS = ("attn", "attn_local", "attn_bidir", "attn_cross")


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of a nested dict (and the leaves at the same
    paths of ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _stack(trees: list):
    """Stack a list of same-structure nested dicts along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg, mixer: str, ffn: str) -> dict:
    dev = gen.device
    p = {"ln1": init_norm(cfg, cfg.d_model, dev)}
    if mixer in _ATTN_KINDS:
        p["mixer"] = attn.init_attention(gen, cfg)
        if mixer == "attn_cross":
            p["ln_cross"] = init_norm(cfg, cfg.d_model, dev)
            p["cross"] = attn.init_attention(gen, cfg, cross=True)
    elif mixer == "mamba":
        p["mixer"] = mamba_mod.init_mamba(gen, cfg)
    elif mixer == "rwkv":
        p["mixer"] = rwkv_mod.init_rwkv_time_mix(gen, cfg)
    else:
        raise ValueError(mixer)
    if ffn != "none":
        p["ln2"] = init_norm(cfg, cfg.d_model, dev)
    if ffn == "mlp":
        p["ffn"] = init_mlp(gen, cfg)
    elif ffn == "moe":
        p["ffn"] = init_moe(gen, cfg)
    elif ffn == "rwkv_cm":
        p["ffn"] = rwkv_mod.init_rwkv_channel_mix(gen, cfg)
    elif ffn != "none":
        raise ValueError(ffn)
    if cfg.post_norm:
        p["post_ln1"] = init_norm(cfg, cfg.d_model, dev)
        if ffn != "none":
            p["post_ln2"] = init_norm(cfg, cfg.d_model, dev)
    return p


def _init_units(gen, cfg, pattern, n_units: int) -> dict:
    return _stack([{f"b{i}": _init_block(gen, cfg, mixer, ffn)
                    for i, (mixer, ffn) in enumerate(pattern)}
                   for _ in range(n_units)])


def init_model(gen, cfg, device=None) -> dict:
    """Random parameters of ``cfg`` drawn from ``gen``: a
    ``torch.Generator`` (the tensors are made on its device), or an int
    seed for a generator on ``device`` (default ``cuda``)."""
    if not isinstance(gen, torch.Generator):
        from ..api.plan import resolve_device

        gen = torch.Generator(resolve_device(device)).manual_seed(int(gen))
    params = {"embed": init_embedding(gen, cfg),
              "final_norm": init_norm(cfg, cfg.d_model, gen.device),
              "head": init_lm_head(gen, cfg)}
    params["units"] = _init_units(gen, cfg, cfg.unit_pattern, cfg.n_units)
    if cfg.family == "encdec":
        n_enc_units = cfg.n_enc_layers // len(cfg.enc_unit_pattern)
        params["enc_units"] = _init_units(gen, cfg, cfg.enc_unit_pattern,
                                          n_enc_units)
        params["enc_final_norm"] = init_norm(cfg, cfg.d_model, gen.device)
    return params


# ---------------------------------------------------------------------------
# unit application (shared by train / prefill / decode)
# ---------------------------------------------------------------------------

def _write_prefix(cache: torch.Tensor, new: torch.Tensor,
                  donate: bool = False) -> torch.Tensor:
    """``cache`` with its first ``new.shape[1]`` positions set to ``new``
    (the rank's block of it, as the cache holds it: its heads or head_dim,
    and under context parallelism the positions in its block of the
    sequence); ``cache`` itself, written in place, when ``donate``."""
    out = cache if donate else cache.clone()
    if shard_ctx.ctx_split() is not None:
        start, s = attn.seq_start(cache), new.shape[1]
        new = new[:, min(start, s):min(start + cache.shape[1], s)]
    out[:, :new.shape[1]] = attn.cache_part(new, cache).to(cache.dtype)
    return out


def _carry(st: dict, new: dict, donate: bool) -> dict:
    """A recurrent block's new state ``new`` in the dtypes of its old one
    ``st``: written into ``st``'s tensors in place when ``donate``."""
    if donate:
        for k, v in new.items():
            st[k].copy_(v)
        return {k: st[k] for k in new}
    return {k: v.to(st[k].dtype) for k, v in new.items()}


def _apply_unit(up, x, cfg, pattern, mode, state=None, enc_out=None,
                pos=None, pos_offset=0, skip_causal=False, donate=False):
    """Returns (x, aux, new_state).  ``donate``: the attention caches and
    the recurrent states are written in place."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_state = {} if state is not None else None
    for i, (mixer, ffn) in enumerate(pattern):
        bp = up[f"b{i}"]
        bkey = f"b{i}"
        st = state[bkey] if state is not None else None
        h = apply_norm(bp["ln1"], x, cfg)
        # ---- mixer -------------------------------------------------------
        if mixer in _ATTN_KINDS:
            out = _attention_mixer(bp, x, h, cfg, mixer, mode, st, new_state,
                                   bkey, enc_out, pos, pos_offset,
                                   skip_causal, donate)
        elif mixer == "mamba":
            out, new_st = mamba_mod.apply_mamba(bp["mixer"], h, cfg, st)
            if state is not None:
                new_state[bkey] = _carry(st, new_st, donate)
        elif mixer == "rwkv":
            # reads the sequence whole (its token shift and scan), its
            # split inside, under a sequence-parallel context too
            out, (x_last, wkv) = rwkv_mod.apply_rwkv_time_mix(
                bp["mixer"], shard_ctx.enter_block(h, False), cfg,
                x_prev=None if st is None else st["x_prev_tm"],
                wkv_state=None if st is None else st["wkv"])
            out = shard_ctx.leave_block(out, False)
            if state is not None:
                new_state[bkey] = _carry(
                    st, {"x_prev_tm": x_last, "wkv": wkv}, donate)
        else:
            raise ValueError(mixer)
        if cfg.post_norm:
            out = apply_norm(bp["post_ln1"], out, cfg)
        x = x + out
        # ---- ffn ----------------------------------------------------------
        if ffn == "none":
            continue
        h2 = apply_norm(bp["ln2"], x, cfg)
        if ffn == "mlp":
            out = apply_mlp(bp["ffn"], h2, cfg)
        elif ffn == "moe":
            out, a = apply_moe(bp["ffn"], h2, cfg)
            aux = aux + a
        elif ffn == "rwkv_cm":
            prev = None if st is None else st.get("x_prev_cm")
            out, x_last_cm = rwkv_mod.apply_rwkv_channel_mix(
                bp["ffn"], shard_ctx.enter_block(h2, False), cfg,
                x_prev=prev)
            out = shard_ctx.leave_block(out, False)
            if state is not None:
                new_state[bkey].update(_carry(
                    st, {"x_prev_cm": x_last_cm}, donate))
        else:
            raise ValueError(ffn)
        if cfg.post_norm:
            out = apply_norm(bp["post_ln2"], out, cfg)
        x = x + out
    return x, aux, new_state


def _attention_mixer(bp, x, h, cfg, mixer, mode, st, new_state, bkey,
                     enc_out, pos, pos_offset, skip_causal, donate=False):
    """An attention block's mixer output; fills ``new_state[bkey]`` in the
    prefill and decode modes."""
    # the self-attention of a cross block is ordinary causal attn;
    # "attn_cross" selects only the *extra* cross-attention below
    self_kind = "attn" if mixer == "attn_cross" else mixer
    if mode == "decode":
        out, kv = attn.decode_attention(
            bp["mixer"], h, {"k": st["k"], "v": st["v"]}, pos, cfg,
            kind=self_kind, donate=donate)
        new_state[bkey] = dict(kv)
    else:
        out, (k, v) = attn.apply_attention(
            bp["mixer"], h, cfg, kind=self_kind, pos_offset=pos_offset,
            block_skip_causal=skip_causal)
        if mode == "prefill":
            new_state[bkey] = {"k": _write_prefix(st["k"], k, donate),
                               "v": _write_prefix(st["v"], v, donate)}
    if mixer == "attn_cross":
        hc = apply_norm(bp["ln_cross"], x + out, cfg)
        if mode == "decode":
            out2 = attn.decode_cross_attention(bp["cross"], hc,
                                               (st["ck"], st["cv"]), cfg)
            new_state[bkey]["ck"] = st["ck"]
            new_state[bkey]["cv"] = st["cv"]
        else:
            out2, (ck, cv) = attn.apply_attention(
                bp["cross"], hc, cfg, kind="attn_cross", kv_x=enc_out)
            if mode == "prefill":
                for key, new in (("ck", ck), ("cv", cv)):
                    new_state[bkey][key] = (
                        _write_prefix(st[key], new, True) if donate
                        else new.to(st[key].dtype))
        out = out + out2
    return out


def _unstack(tree, n: int) -> list:
    """A stacked (n, ...) tree as n trees, each leaf unbound once."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda parts, u=u: parts[u], split) for u in range(n)]


def _gathered_unit(gather, up, *args):
    return _apply_unit(gather(up), *args)


def _unit_in_place(gather, up, *args):
    """One unit of the mesh prefill or decode: its parameters gathered,
    its caches written in place; returns (x, aux)."""
    x, aux, _ = _apply_unit(gather(up), *args, donate=True)
    return x, aux


def _run_units(units_params, x, cfg, pattern, mode, states=None,
               enc_out=None, pos=None, pos_offset=0, skip_causal=False,
               gather=None, donate=False):
    """The unit stack, one unit after another (the reference's scan).
    states: stacked (n_units, ...) tree or None.  ``gather(up)``, when
    given, turns one unit's parameters into those it computes with, inside
    the checkpointed unit.  ``donate`` (the mesh prefill and decode, no
    gradient): each unit runs as a ``layers.region`` that writes its
    caches in place, and ``states`` itself is returned."""
    n_units = next(iter(tree_leaves(units_params))).shape[0]
    ups = _unstack(units_params, n_units)
    sts = [None] * n_units if states is None else _unstack(states, n_units)
    use_remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if donate:
        for up, st in zip(ups, sts):
            x, a = region(_unit_in_place, gather, up, x, cfg, pattern, mode,
                          st, enc_out, pos, pos_offset, skip_causal)
            aux = aux + a
        return x, aux, states
    new_states = []
    for up, st in zip(ups, sts):
        fn, args = _apply_unit, (up, x, cfg, pattern, mode, st, enc_out, pos,
                                 pos_offset, skip_causal)
        if gather is not None:
            fn, args = _gathered_unit, (gather,) + args
        x, a, new_st = remat(fn, *args) if use_remat else fn(*args)
        aux = aux + a
        new_states.append(new_st)
    return x, aux, None if states is None else _stack(new_states)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _as_tokens(tokens, params) -> torch.Tensor:
    dev = params["embed"]["embedding"].device
    return torch.as_tensor(tokens, device=dev).long()


def _unit_gather(gather, key):
    return None if gather is None else (lambda up: gather(key, up))


def _encode(params, enc_frames, cfg, gather=None, donate=False):
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend: the caller provides the frames)."""
    dev = params["embed"]["embedding"].device
    x = torch.as_tensor(enc_frames, device=dev).to(cdtype(cfg))
    if cfg.pos_embedding == "learned":
        s = x.shape[1]
        x = x + params["embed"]["pos_embedding"][:s].to(x.dtype)
    x, _, _ = _run_units(params["enc_units"], x, cfg, cfg.enc_unit_pattern,
                         "train", gather=_unit_gather(gather, "enc_units"),
                         donate=donate)
    return apply_norm(params["enc_final_norm"], x, cfg)


def forward(params, batch, cfg, *, skip_causal=False, gather=None):
    """Training/scoring forward: batch {"tokens": (B,S)[, "enc_frames"]}.
    Returns (hidden (B,S,d), moe_aux).  ``gather(key, unit_params)``: see
    the module docstring."""
    x = embed_tokens(params["embed"], _as_tokens(batch["tokens"], params),
                     cfg)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, batch["enc_frames"], cfg, gather)
    x, aux, _ = _run_units(params["units"], x, cfg, cfg.unit_pattern,
                           "train", enc_out=enc_out, skip_causal=skip_causal,
                           gather=_unit_gather(gather, "units"))
    x = apply_norm(params["final_norm"], x, cfg)
    return x, aux


def init_decode_state(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      enc_len: int = 0, device=None) -> dict:
    """Stacked per-unit decode state (KV caches, the encoder's cross K/V
    for an encoder-decoder, Mamba's conv and SSM states, RWKV's shifted
    tokens and WKV state) on ``device`` (default ``cuda``)."""
    from ..api.plan import resolve_device

    device = resolve_device(device)
    unit_state = {}
    for i, (mixer, ffn) in enumerate(cfg.unit_pattern):
        key = f"b{i}"
        if mixer in _ATTN_KINDS:
            st = attn.init_kv_cache(cfg, batch, max_len, dtype, device)
            if mixer == "attn_cross":
                shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
                st["ck"] = torch.zeros(shape, dtype=dtype, device=device)
                st["cv"] = torch.zeros(shape, dtype=dtype, device=device)
            unit_state[key] = st
        elif mixer == "mamba":
            unit_state[key] = mamba_mod.init_mamba_state(cfg, batch, dtype,
                                                         device)
        elif mixer == "rwkv":
            rs = rwkv_mod.init_rwkv_state(cfg, batch, dtype, device)
            unit_state[key] = {"x_prev_tm": rs["x_prev_tm"], "wkv": rs["wkv"]}
        if ffn == "rwkv_cm":
            unit_state[key]["x_prev_cm"] = torch.zeros(
                (batch, 1, cfg.d_model), dtype=dtype, device=device)
    return tree_map(
        lambda a: a.new_zeros((cfg.n_units,) + tuple(a.shape)), unit_state)


def prefill(params, batch, cfg, state, *, skip_causal=False, mesh=None,
            specs=None, state_specs=None):
    """Fill the decode state from a prompt; returns (hidden_last (B,1,d),
    state').  The hidden state is the one at the last position of
    ``batch["tokens"]``, padding included, as the reference's is.
    ``skip_causal`` enables the triangular block enumeration.  With a
    ``mesh``: the mesh prefill (module docstring), which writes ``state``
    in place and returns it with the rank's rows of the hidden state."""
    if mesh is not None:
        return _mesh_serve(params, cfg, state, mesh, specs, "prefill",
                           batch=batch, skip_causal=skip_causal,
                           state_specs=state_specs)
    x = embed_tokens(params["embed"], _as_tokens(batch["tokens"], params),
                     cfg)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, batch["enc_frames"], cfg)
    x, _, new_state = _run_units(params["units"], x, cfg, cfg.unit_pattern,
                                 "prefill", states=state, enc_out=enc_out,
                                 skip_causal=skip_causal)
    x = apply_norm(params["final_norm"], x, cfg)
    return x[:, -1:, :], new_state


def decode_step(params, tokens, cfg, state, pos, *, mesh=None, specs=None,
                state_specs=None):
    """One decode step: tokens (B,1) at position ``pos`` — an int when all
    rows advance in lock-step, or a (B,) int tensor of per-row positions
    (continuous batching: slots admitted at different times each write
    their KV-cache entry, RoPE angle, and learned-position lookup at their
    own index).  Returns (hidden (B,1,d), new state).  With a ``mesh``:
    the mesh decode step (module docstring), which writes ``state`` in
    place and returns it with the rank's rows of the hidden state."""
    if mesh is not None:
        return _mesh_serve(params, cfg, state, mesh, specs, "decode",
                           batch={"tokens": tokens}, pos=pos,
                           state_specs=state_specs)
    dev = params["embed"]["embedding"].device
    pos = torch.as_tensor(pos, device=dev)
    x = embed_tokens(params["embed"], _as_tokens(tokens, params), cfg,
                     pos_offset=pos)
    x, _, new_state = _run_units(params["units"], x, cfg, cfg.unit_pattern,
                                 "decode", states=state, pos=pos)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, new_state


# ---------------------------------------------------------------------------
# the mesh prefill and decode
# ---------------------------------------------------------------------------

UNIT_KEYS = ("units", "enc_units")        # the stacked parameter trees


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class MeshParams(NamedTuple):
    """The params of the mesh prefill and decode, prepared once:
    ``local`` the rank's shards, ``rules`` their ``serve_gather_rules``."""
    local: dict
    rules: dict


def mesh_params(params, cfg, mesh, specs=None) -> MeshParams:
    """:class:`MeshParams` of ``params``: ``DTensor``s (their specs read
    back) or local shards under ``specs``.  ``prefill``, ``decode_step``
    and ``serve_logits`` take the result in place of ``params`` (else
    they prepare it on every call); ``params`` already prepared are
    returned as they are."""
    from ..launch.sharding import serve_gather_rules, spec_of

    if isinstance(params, MeshParams):
        return params
    if specs is None:
        specs = tree_map(spec_of, params)
    return MeshParams(tree_map(_local, params),
                      serve_gather_rules(specs, mesh, cfg))


def _rows(x, split, mesh, dev):
    """The rank's rows of a batch leaf: a ``DTensor``'s local block, or
    this rank's block of the global rows over ``split`` (all of them for
    no axes)."""
    from ..launch.sharding import local_block

    if getattr(x, "to_local", None) is not None:
        return x.to_local().to(dev)
    x = torch.as_tensor(x, device=dev)
    if not split or x.ndim == 0:
        return x
    return local_block(x, (split,) + (None,) * (x.ndim - 1), mesh)


def _batch_split(mesh, cfg, rows: int) -> tuple:
    """The axes a global batch of ``rows`` splits over: the batch axes
    where they divide it (as ``state_specs`` splits the state), else
    none."""
    from ..launch.sharding import dp_axes

    b_axes = dp_axes(mesh, cfg)
    return b_axes if rows % shard_ctx.group_size(mesh, b_axes) == 0 else ()


def _context_axes(state, state_specs, mesh, split) -> tuple:
    """The axes the state's KV caches split their sequence over (their
    specs' second entry after the unit stack's: ``state_specs``, else the
    ``DTensor``s' own, else none), over a live group.  Raises where the
    caches split it differently or the batch is split over them too."""
    from ..launch.sharding import _leaf_name, _map_with_path, spec_of

    if state_specs is None:
        state_specs = tree_map(spec_of, state)
    found = set()

    def one(path, spec):
        if _leaf_name(path) in ("k", "v", "ck", "cv"):
            entry = spec[2] if len(spec) > 2 else None
            found.add(shard_ctx._live(mesh, entry))

    _map_with_path(one, state_specs)
    if len(found) > 1:
        raise ValueError(f"the caches split their sequence over different "
                         f"axes: {sorted(found)}")
    axes = found.pop() if found else ()
    if set(axes) & set(split):
        raise ValueError(f"the caches' sequence and the batch both split "
                         f"over {axes}")
    return axes


@contextlib.contextmanager
def _serving(mesh, cfg, split, ctx=(), seq=()):
    """The sharding context of the mesh prefill and decode (the layers
    split over `model`, the caches' sequence over ``ctx``, the residual
    stream's over ``seq``), without gradients."""
    from ..launch.sharding import dp_axes, tp_axes

    saved = dict(shard_ctx._CTX)
    shard_ctx.set_sharding_context(mesh, dp_axes(mesh, cfg), split=split,
                                   tp=tp_axes(mesh, cfg), ctx=ctx, seq=seq)
    try:
        with torch.no_grad():
            yield
    finally:
        shard_ctx._CTX.update(saved)


def _last_position(x):
    """The hidden state at the last position of the sequence, (B, 1, d):
    under a sequence-parallel context the last rank's block holds it, so
    the ranks' last rows are gathered and the last one kept."""
    seq = shard_ctx.seq_split()
    if seq is not None:
        x = shard_ctx.gather_from(x[:, -1:, :], 1, *seq)
    return x[:, -1:, :]


def _mesh_serve(params, cfg, state, mesh, specs, mode, *, batch, pos=None,
                skip_causal=False, state_specs=None):
    from ..launch.sharding import seq_axes

    local, rules = mesh_params(params, cfg, mesh, specs)
    dev = local["embed"]["embedding"].device
    split = _batch_split(mesh, cfg, batch["tokens"].shape[0])
    ctx = _context_axes(state, state_specs, mesh, split)
    seq = seq_axes(mesh, cfg, batch["tokens"].shape[1]) \
        if mode == "prefill" else ()
    tokens = _rows(batch["tokens"], split, mesh, dev).long()
    if pos is not None:
        pos = _rows(pos, split, mesh, dev)
    states = tree_map(_local, state)

    def gather(key, up):
        return shard_ctx.gather_tree(up, rules[key], mesh)

    with _serving(mesh, cfg, split, ctx, seq):
        full = {k: v if k in UNIT_KEYS
                else shard_ctx.gather_tree(v, rules[k], mesh)
                for k, v in local.items()}
        x = embed_tokens(full["embed"], tokens, cfg,
                         pos_offset=0 if pos is None else pos)
        enc_out = None
        if cfg.family == "encdec" and mode == "prefill":
            enc_out = _encode(full, _rows(batch["enc_frames"], split, mesh,
                                          dev), cfg, gather, donate=True)
        x, _, _ = _run_units(full["units"], x, cfg, cfg.unit_pattern, mode,
                             states=states, enc_out=enc_out, pos=pos,
                             skip_causal=skip_causal,
                             gather=_unit_gather(gather, "units"),
                             donate=True)
        x = apply_norm(full["final_norm"], x, cfg)
        if mode == "prefill":
            x = _last_position(x)
    return x, state


def serve_logits(params, h, cfg, *, mesh=None, specs=None,
                 global_batch=None):
    """Logits of hidden states ``h``: ``layers.logits_fn`` off a mesh.  On
    a mesh (``params`` as ``prefill(..., mesh=)`` takes them, ``h`` the
    rank's rows it returns for a batch of ``global_batch`` rows): the
    rank's block of the vocab for every row, ``(B, S, V/|model|)`` — the
    head on the rank's rows, then those rows gathered over the batch
    axes."""
    if mesh is None:
        return logits_fn(params["head"], params["embed"], h, cfg)
    if global_batch is None:
        raise ValueError("serve_logits on a mesh needs the global batch's "
                         "rows (h holds this rank's)")
    local, rules = mesh_params(params, cfg, mesh, specs)
    split = _batch_split(mesh, cfg, global_batch)
    with _serving(mesh, cfg, split):
        out = logits_fn(
            shard_ctx.gather_tree(local["head"], rules["head"], mesh),
            shard_ctx.gather_tree(local["embed"], rules["embed"], mesh),
            h, cfg)
        return shard_ctx.gather_from(out, 0, mesh, split)


__all__ = ["init_model", "forward", "init_decode_state", "prefill",
           "decode_step", "serve_logits", "mesh_params", "MeshParams",
           "tree_map", "tree_leaves"]

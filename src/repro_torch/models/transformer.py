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
(``layers.logits_fn``, ``layers.chunked_xent``).  No entry point modifies
the state it is given.

On a mesh the train step hands ``forward`` the units' parameters as this
rank's shards and a ``gather(key, unit_params)`` callable (``key`` is
``"units"`` or ``"enc_units"``) that all-gathers one unit's leaves; it runs
inside the checkpointed unit, so the backward pass gathers again instead of
keeping every unit's full weights alive (where the reference passes
``shard_act`` to its scan body).  Without it nothing changes.
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import mamba as mamba_mod
from . import rwkv as rwkv_mod
from .layers import (apply_mlp, apply_norm, cdtype, embed_tokens,
                     init_embedding, init_lm_head, init_mlp, init_norm,
                     remat)
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

def _write_prefix(cache: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``cache`` with its first ``new.shape[1]`` positions set to ``new``."""
    out = cache.clone()
    out[:, :new.shape[1]] = new.to(cache.dtype)
    return out


def _apply_unit(up, x, cfg, pattern, mode, state=None, enc_out=None,
                pos=None, pos_offset=0, skip_causal=False):
    """Returns (x, aux, new_state)."""
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
                                   skip_causal)
        elif mixer == "mamba":
            out, new_st = mamba_mod.apply_mamba(bp["mixer"], h, cfg, st)
            if state is not None:
                new_state[bkey] = new_st
        elif mixer == "rwkv":
            out, (x_last, wkv) = rwkv_mod.apply_rwkv_time_mix(
                bp["mixer"], h, cfg,
                x_prev=None if st is None else st["x_prev_tm"],
                wkv_state=None if st is None else st["wkv"])
            if state is not None:
                new_state[bkey] = {
                    "x_prev_tm": x_last.to(st["x_prev_tm"].dtype),
                    "wkv": wkv.to(st["wkv"].dtype)}
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
                bp["ffn"], h2, cfg, x_prev=prev)
            if state is not None:
                new_state[bkey]["x_prev_cm"] = x_last_cm.to(
                    st["x_prev_cm"].dtype)
        else:
            raise ValueError(ffn)
        if cfg.post_norm:
            out = apply_norm(bp["post_ln2"], out, cfg)
        x = x + out
    return x, aux, new_state


def _attention_mixer(bp, x, h, cfg, mixer, mode, st, new_state, bkey,
                     enc_out, pos, pos_offset, skip_causal):
    """An attention block's mixer output; fills ``new_state[bkey]`` in the
    prefill and decode modes."""
    # the self-attention of a cross block is ordinary causal attn;
    # "attn_cross" selects only the *extra* cross-attention below
    self_kind = "attn" if mixer == "attn_cross" else mixer
    if mode == "decode":
        out, kv = attn.decode_attention(
            bp["mixer"], h, {"k": st["k"], "v": st["v"]}, pos, cfg,
            kind=self_kind)
        new_state[bkey] = dict(kv)
    else:
        out, (k, v) = attn.apply_attention(
            bp["mixer"], h, cfg, kind=self_kind, pos_offset=pos_offset,
            block_skip_causal=skip_causal)
        if mode == "prefill":
            new_state[bkey] = {"k": _write_prefix(st["k"], k),
                               "v": _write_prefix(st["v"], v)}
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
                new_state[bkey]["ck"] = ck.to(st["ck"].dtype)
                new_state[bkey]["cv"] = cv.to(st["cv"].dtype)
        out = out + out2
    return out


def _unstack(tree, n: int) -> list:
    """A stacked (n, ...) tree as n trees, each leaf unbound once."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda parts, u=u: parts[u], split) for u in range(n)]


def _gathered_unit(gather, up, *args):
    return _apply_unit(gather(up), *args)


def _run_units(units_params, x, cfg, pattern, mode, states=None,
               enc_out=None, pos=None, pos_offset=0, skip_causal=False,
               gather=None):
    """The unit stack, one unit after another (the reference's scan).
    states: stacked (n_units, ...) tree or None.  ``gather(up)``, when
    given, turns one unit's parameters into those it computes with, inside
    the checkpointed unit."""
    n_units = next(iter(tree_leaves(units_params))).shape[0]
    ups = _unstack(units_params, n_units)
    sts = [None] * n_units if states is None else _unstack(states, n_units)
    use_remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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


def _encode(params, enc_frames, cfg, gather=None):
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend: the caller provides the frames)."""
    dev = params["embed"]["embedding"].device
    x = torch.as_tensor(enc_frames, device=dev).to(cdtype(cfg))
    if cfg.pos_embedding == "learned":
        s = x.shape[1]
        x = x + params["embed"]["pos_embedding"][:s].to(x.dtype)
    x, _, _ = _run_units(params["enc_units"], x, cfg, cfg.enc_unit_pattern,
                         "train", gather=_unit_gather(gather, "enc_units"))
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


def prefill(params, batch, cfg, state, *, skip_causal=False):
    """Fill the decode state from a prompt; returns (hidden_last (B,1,d),
    state').  The hidden state is the one at the last position of
    ``batch["tokens"]``, padding included, as the reference's is.
    ``skip_causal`` enables the triangular block enumeration."""
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


def decode_step(params, tokens, cfg, state, pos):
    """One decode step: tokens (B,1) at position ``pos`` — an int when all
    rows advance in lock-step, or a (B,) int tensor of per-row positions
    (continuous batching: slots admitted at different times each write
    their KV-cache entry, RoPE angle, and learned-position lookup at their
    own index).  Returns (hidden (B,1,d), new state)."""
    dev = params["embed"]["embedding"].device
    pos = torch.as_tensor(pos, device=dev)
    x = embed_tokens(params["embed"], _as_tokens(tokens, params), cfg,
                     pos_offset=pos)
    x, _, new_state = _run_units(params["units"], x, cfg, cfg.unit_pattern,
                                 "decode", states=state, pos=pos)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, new_state


__all__ = ["init_model", "forward", "init_decode_state", "prefill",
           "decode_step", "tree_map", "tree_leaves"]

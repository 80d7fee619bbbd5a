"""Model assembly: a loop over units covering the attention families of the
assigned architectures (dense GQA, local/global alternation,
encoder-decoder, early-fusion VLM).

The port of ``repro.models.transformer``.  A *unit* is the repeating group
of (mixer, ffn) blocks (``cfg.unit_pattern``); parameters and decode states
are stacked along a leading ``n_units`` axis, as the reference's are, and a
Python loop over that axis replaces its ``lax.scan`` (``cfg.remat`` has no
effect: nothing here is differentiated through a scan).

The mixers ``mamba`` and ``rwkv`` and the ffns ``moe`` and ``rwkv_cm`` are
not ported yet (ROADMAP Queue 1 item 9): a model that holds one raises
``NotImplementedError`` at init and at apply.  So six of the ten
architectures run: llama3_2_1b, yi_6b, phi3_mini_3_8b, gemma2_2b,
chameleon_34b and whisper_tiny.

Three entry points:
  forward(params, batch, cfg)                      → (hidden, moe aux)
  prefill(params, batch, cfg, state)               → (hidden_last, state')
  decode_step(params, tokens, cfg, state, pos)     → (hidden, state')
The caller turns hidden states into logits (``layers.logits_fn``).  No
entry point modifies the state it is given.
"""

from __future__ import annotations

import torch

from . import attention as attn
from .layers import (apply_mlp, apply_norm, cdtype, embed_tokens,
                     init_embedding, init_lm_head, init_mlp, init_norm)

_ATTN_KINDS = ("attn", "attn_local", "attn_bidir", "attn_cross")
_UNPORTED = ("mamba", "rwkv", "moe", "rwkv_cm")


def _unported(kind: str):
    return NotImplementedError(
        f"{kind!r} blocks are not ported yet (ROADMAP Queue 1 item 9: "
        f"models/moe.py, mamba.py and rwkv.py come with the next slice)")


def _check_ported(cfg) -> None:
    for pattern in (cfg.unit_pattern, cfg.enc_unit_pattern):
        for mixer, ffn in pattern:
            for kind in (mixer, ffn):
                if kind in _UNPORTED:
                    raise _unported(kind)


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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
    elif mixer in _UNPORTED:
        raise _unported(mixer)
    else:
        raise ValueError(mixer)
    if ffn != "none":
        p["ln2"] = init_norm(cfg, cfg.d_model, dev)
    if ffn == "mlp":
        p["ffn"] = init_mlp(gen, cfg)
    elif ffn in _UNPORTED:
        raise _unported(ffn)
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
    _check_ported(cfg)
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
        h = apply_norm(bp["ln1"], x, cfg)
        # ---- mixer -------------------------------------------------------
        if mixer not in _ATTN_KINDS:
            raise _unported(mixer)
        # the self-attention of a cross block is ordinary causal attn;
        # "attn_cross" selects only the *extra* cross-attention below
        self_kind = "attn" if mixer == "attn_cross" else mixer
        if mode == "decode":
            out, kv = attn.decode_attention(
                bp["mixer"], h, {"k": state[bkey]["k"],
                                 "v": state[bkey]["v"]},
                pos, cfg, kind=self_kind)
            new_state[bkey] = dict(kv)
        else:
            out, (k, v) = attn.apply_attention(
                bp["mixer"], h, cfg, kind=self_kind,
                pos_offset=pos_offset, block_skip_causal=skip_causal)
            if mode == "prefill":
                new_state[bkey] = {"k": _write_prefix(state[bkey]["k"], k),
                                   "v": _write_prefix(state[bkey]["v"], v)}
        if mixer == "attn_cross":
            hc = apply_norm(bp["ln_cross"], x + out, cfg)
            if mode == "decode":
                out2 = attn.decode_cross_attention(
                    bp["cross"], hc, (state[bkey]["ck"],
                                      state[bkey]["cv"]), cfg)
                new_state[bkey]["ck"] = state[bkey]["ck"]
                new_state[bkey]["cv"] = state[bkey]["cv"]
            else:
                out2, (ck, cv) = attn.apply_attention(
                    bp["cross"], hc, cfg, kind="attn_cross", kv_x=enc_out)
                if mode == "prefill":
                    new_state[bkey]["ck"] = ck.to(state[bkey]["ck"].dtype)
                    new_state[bkey]["cv"] = cv.to(state[bkey]["cv"].dtype)
            out = out + out2
        if cfg.post_norm:
            out = apply_norm(bp["post_ln1"], out, cfg)
        x = x + out
        # ---- ffn ----------------------------------------------------------
        if ffn == "none":
            continue
        if ffn != "mlp":
            raise _unported(ffn)
        h2 = apply_norm(bp["ln2"], x, cfg)
        out = apply_mlp(bp["ffn"], h2, cfg)
        if cfg.post_norm:
            out = apply_norm(bp["post_ln2"], out, cfg)
        x = x + out
    return x, aux, new_state


def _run_units(units_params, x, cfg, pattern, mode, states=None,
               enc_out=None, pos=None, pos_offset=0, skip_causal=False):
    """The unit stack, one unit after another (the reference's scan).
    states: stacked (n_units, ...) tree or None."""
    n_units = next(iter(tree_leaves(units_params))).shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states = []
    for u in range(n_units):
        up = tree_map(lambda a: a[u], units_params)
        st = None if states is None else tree_map(lambda a: a[u], states)
        x, a, new_st = _apply_unit(
            up, x, cfg, pattern, mode, state=st, enc_out=enc_out, pos=pos,
            pos_offset=pos_offset, skip_causal=skip_causal)
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


def _encode(params, enc_frames, cfg):
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend: the caller provides the frames)."""
    dev = params["embed"]["embedding"].device
    x = torch.as_tensor(enc_frames, device=dev).to(cdtype(cfg))
    if cfg.pos_embedding == "learned":
        s = x.shape[1]
        x = x + params["embed"]["pos_embedding"][:s].to(x.dtype)
    x, _, _ = _run_units(params["enc_units"], x, cfg, cfg.enc_unit_pattern,
                         "train")
    return apply_norm(params["enc_final_norm"], x, cfg)


def forward(params, batch, cfg, *, skip_causal=False):
    """Training/scoring forward: batch {"tokens": (B,S)[, "enc_frames"]}.
    Returns (hidden (B,S,d), moe_aux)."""
    _check_ported(cfg)
    x = embed_tokens(params["embed"], _as_tokens(batch["tokens"], params),
                     cfg)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, batch["enc_frames"], cfg)
    x, aux, _ = _run_units(params["units"], x, cfg, cfg.unit_pattern,
                           "train", enc_out=enc_out, skip_causal=skip_causal)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, aux


def init_decode_state(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      enc_len: int = 0, device=None) -> dict:
    """Stacked per-unit decode state (KV caches; the encoder's cross K/V
    for an encoder-decoder) on ``device`` (default ``cuda``)."""
    from ..api.plan import resolve_device

    _check_ported(cfg)
    device = resolve_device(device)
    unit_state = {}
    for i, (mixer, _ffn) in enumerate(cfg.unit_pattern):
        st = attn.init_kv_cache(cfg, batch, max_len, dtype, device)
        if mixer == "attn_cross":
            shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
            st["ck"] = torch.zeros(shape, dtype=dtype, device=device)
            st["cv"] = torch.zeros(shape, dtype=dtype, device=device)
        unit_state[f"b{i}"] = st
    return tree_map(
        lambda a: a.new_zeros((cfg.n_units,) + tuple(a.shape)), unit_state)


def prefill(params, batch, cfg, state, *, skip_causal=False):
    """Fill the decode state from a prompt; returns (hidden_last (B,1,d),
    state').  The hidden state is the one at the last position of
    ``batch["tokens"]``, padding included, as the reference's is.
    ``skip_causal`` enables the triangular block enumeration."""
    _check_ported(cfg)
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
    _check_ported(cfg)
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

"""GQA attention: masked softmax attention with causal/bidirectional/
sliding-window masks, logit softcap (Gemma-2), QK-norm (Chameleon), RoPE,
cross-attention (Whisper), and a KV-cache decode path.

The port of ``repro.models.attention``.  The reference's
``flash_attention`` and ``_grouped_decode_attention`` are doubly-chunked
online-softmax scans written in ``jax.numpy`` (no Pallas kernel); their port
computes the same masked softmax with plain tensor ops: a loop over query
chunks bounds the live score block at (B, Hkv, G, Cq, Sk), and GQA stays
grouped (the KV heads are never repeated).  Scores, the softmax statistics
and the weighted sum's accumulation are fp32; the probabilities are cast to
the value dtype before the product with V, as the reference's are.
``block_skip_causal=True`` keeps, for each query chunk, only the key
blocks that hold an unmasked position (the reference's triangular block
enumeration), so its result is the masked one.

Decode (one query row against a cache) is the reference's
``_grouped_decode_attention``: an online softmax over ``chunk_kv``-row
chunks of the cache, so no whole-cache copy or score row is ever live.

The reference pins head and batch shardings with ``shard_ctx.constrain``;
in one process that call has no meaning, so the port drops it.

**On a mesh** (a tensor-parallel context, ``shard_ctx.tp_split``) each
projection is whole or the rank's block of heads — ``w_q``/``w_o`` where
``n_heads`` divides the axis, ``w_k``/``w_v`` where ``n_kv_heads`` does —
or, for ``w_k``/``w_v`` where it does not, the rank's block of columns,
whose products are gathered over the group (:func:`_project_qkv`); the
layer reads which from its shape.  The rank computes its own query heads
against the kv heads they read (all of them when the query heads are
whole), and ``w_o``'s rows are summed over the group
(``shard_ctx.leave_block``).  Under a sequence-parallel context the
layer's input is the rank's block of the sequence: the projections'
entry gathers the sequence (before RoPE and the causal mask read
positions) and ``w_o``'s sum is reduce-scattered back onto the blocks.
The cache a rank holds follows the state's specs, chosen per cache:

* **head-parallel** — the cache holds the rank's kv heads (``n_kv_heads``
  divides the axis): everything stays local;
* **head_dim-parallel** — the cache holds every kv head's block of
  head_dim: a decode step gathers the query heads, takes its block of
  head_dim, sums the partial scores over the group before the softmax,
  and gathers the output's head_dim blocks before ``w_o``.

A prefill never reads the cache: it attends over the k and v it has just
computed and writes the rank's block of them into the cache
(:func:`cache_part`).  With ``donate=True`` a decode step writes into the
cache it is handed, as the reference's donated state is.

**Context-parallel decode** (the context's ``ctx`` axes,
``shard_ctx.ctx_split``: ``long_500k``'s caches split their sequence over
`data`): a rank's cache holds the block of positions [i·L, (i+1)·L) for
its index i and L rows.  The new token's k and v are written by the rank
whose block holds ``pos`` only, the rank attends over its block (each
position at its global index) and keeps the online softmax's running
(max, sum, acc) (``grouped_decode_attention(..., partial=True)``), and
the blocks are merged over the axes by one all-reduce MAX of the maxima
and one all-reduce SUM of the rescaled (sum, acc) (:func:`_merge_blocks`).
With the head_dim-parallel layout the scores are summed over `model`
first, so the two compose.
"""

from __future__ import annotations

import numpy as np
import torch

from . import shard_ctx
from .layers import _dense_init, apply_rope, cdtype, pdtype

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, cross: bool = False) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = pdtype(cfg)
    p = {
        "w_q": _dense_init(gen, (d, hq * dh), dt),
        "w_k": _dense_init(gen, (d, hkv * dh), dt),
        "w_v": _dense_init(gen, (d, hkv * dh), dt),
        "w_o": _dense_init(gen, (hq * dh, d), dt,
                           scale=1.0 / np.sqrt(hq * dh)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=dt, device=gen.device)
        p["k_norm"] = torch.ones(dh, dtype=dt, device=gen.device)
    return p


def _qk_normalize(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _choose_chunk(s: int, target: int) -> int:
    c = min(target, s)
    while s % c:
        c //= 2
    return max(c, 1)


def flash_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=0,
                    softcap=0.0, chunk_q=512, chunk_kv=1024,
                    block_skip_causal=False):
    """Masked softmax attention.

    q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D); q_pos: (B,Sq); kv_pos: (B,Sk).
    Returns (B,Sq,Hq,D) in q.dtype.  A query row with no unmasked key
    returns zeros."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    cq = _choose_chunk(sq, chunk_q)
    ck = _choose_chunk(sk, chunk_kv)
    skip = block_skip_causal and causal and sq == sk
    scale = 1.0 / np.sqrt(dh)
    qg = q.reshape(b, sq, hkv, g, dh).float()
    kf = k.float()
    outs = []
    for i in range(sq // cq):
        # the key blocks this query chunk visits: all, or (triangular
        # enumeration) those holding a position <= the chunk's last query
        end = min(sk, -(-((i + 1) * cq) // ck) * ck) if skip else sk
        qi = qg[:, i * cq:(i + 1) * cq]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kf[:, :end]) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        diff = q_pos[:, None, None, i * cq:(i + 1) * cq, None] \
            - kv_pos[:, None, None, None, :end]
        mask = torch.ones_like(diff, dtype=torch.bool)
        if causal:
            mask &= diff >= 0
        if window:
            mask &= diff < window
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.where(mask, torch.exp(s - m), 0.0)
        l = e.sum(dim=-1)                                    # (B,Hkv,G,Cq)
        wv = torch.einsum("bhgqk,bkhd->bqhgd", e.to(v.dtype),
                          v[:, :end]).float()
        lt = l.permute(0, 3, 1, 2)[..., None]
        outs.append((wv / torch.clamp(lt, min=1e-30)).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, sq, hq, dh)


# ---------------------------------------------------------------------------
# module-level apply (train/prefill) and decode
# ---------------------------------------------------------------------------

def _column_input(x, *ws, full):
    """``x`` as the projections ``ws`` read it (``shard_ctx.enter_block``):
    split where any of them is the rank's block of its ``full`` columns
    under a tensor-parallel context — through ``shard_ctx.copy_to``, or
    under a sequence-parallel one the sequence gathered."""
    tp = shard_ctx.tp_split()
    return shard_ctx.enter_block(x, tp is not None and any(
        w.shape[1] < f for w, f in zip(ws, full)))


def _project_qkv(p, x, kv_x, cfg):
    """q, k, v: (B, S, heads, D), the heads the rank's projections hold
    (all of them off a mesh).  Where ``w_k``/``w_v`` hold the rank's block
    of columns but ``n_kv_heads`` does not divide the group (the block cuts
    kv heads), the rank projects its columns and the group gathers them:
    every rank then holds every kv head.  The query heads are then split
    too (``launch.sharding.tp_layout`` keeps these blocks only then), so
    each rank reads other kv heads, and the gather's backward sums the
    gradient over the group."""
    dt = cdtype(cfg)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kv_x is None:
        x = _column_input(x, p["w_q"], p["w_k"], full=(hq * dh, hkv * dh))
    else:
        x = _column_input(x, p["w_q"], full=(hq * dh,))
        kv_x = _column_input(kv_x, p["w_k"], full=(hkv * dh,))
    b, s, _ = x.shape
    q = (x @ p["w_q"].to(dt)).reshape(b, s, -1, dh)
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    k, v = src @ p["w_k"].to(dt), src @ p["w_v"].to(dt)
    tp = shard_ctx.tp_split()
    if tp is not None and k.shape[-1] < hkv * dh and \
            hkv % shard_ctx.group_size(*tp):
        k, v = (shard_ctx.gather_from(t, -1, *tp, sum_grad=True)
                for t in (k, v))
    k, v = k.reshape(b, sk, -1, dh), v.reshape(b, sk, -1, dh)
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
        k = _qk_normalize(k, p["k_norm"])
    return q, k, v


def _tp_index() -> int:
    return shard_ctx.group_index(*shard_ctx.tp_split())


def _kv_for_q(k, v, hq_l: int, cfg):
    """``k``, ``v`` narrowed to the kv heads that the rank's ``hq_l`` query
    heads read, in GQA's grouping: as they are when the query heads are
    whole or the kv heads are the rank's own (which align with them)."""
    if hq_l == cfg.n_heads or k.shape[2] < cfg.n_kv_heads:
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    first = _tp_index() * hq_l
    if hq_l % g == 0 or g % hq_l == 0:      # whole groups, or in one group
        sel = slice(first // g, first // g + max(hq_l // g, 1))
        return k[:, :, sel], v[:, :, sel]
    idx = torch.arange(first, first + hq_l, device=k.device) // g
    return k[:, :, idx], v[:, :, idx]


def _out_proj(out, w_o, cfg):
    """``out @ w_o`` onto the residual stream (``shard_ctx.leave_block``):
    summed over the group, or reduce-scattered onto the ranks' blocks of
    the sequence, where ``w_o`` holds the rank's rows (its query
    heads)."""
    tp = shard_ctx.tp_split()
    return shard_ctx.leave_block(out @ w_o.to(cdtype(cfg)), tp is not None
                                 and w_o.shape[0] < cfg.n_heads
                                 * cfg.head_dim)


def cache_part(new: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """``new`` (B, S, H, D) as ``cache`` holds it: the rank's block of
    heads or of head_dim where the cache holds one (a view)."""
    for d in (2, 3):
        n = cache.shape[d]
        if n < new.shape[d]:
            new = new.narrow(d, _tp_index() * n, n)
    return new


def apply_attention(p, x, cfg, *, kind: str = "attn", kv_x=None,
                    pos_offset=0, block_skip_causal=False):
    """Train/prefill path. kind: attn | attn_local | attn_bidir | attn_cross.
    Returns (out, kv) — kv (k, v) is reused to seed a decode cache.  Under
    a sequence-parallel context ``x`` and ``out`` are the rank's block of
    the sequence, and k and v the whole sequence's."""
    q, k, v = _project_qkv(p, x, kv_x if kind == "attn_cross" else None, cfg)
    b, s = q.shape[:2]
    dev = x.device
    q_pos = (torch.arange(s, device=dev) + pos_offset).expand(b, s)
    sk = k.shape[1]
    kv_pos = (torch.arange(sk, device=dev)
              + (0 if kind == "attn_cross" else pos_offset)).expand(b, sk)
    if cfg.pos_embedding == "rope" and kind != "attn_cross":
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    causal = kind in ("attn", "attn_local")
    window = cfg.window_size if kind == "attn_local" else 0
    ka, va = _kv_for_q(k, v, q.shape[2], cfg)
    out = flash_attention(
        q, ka, va, q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
        softcap=cfg.attn_softcap, block_skip_causal=block_skip_causal)
    out = _out_proj(out.reshape(b, s, -1), p["w_o"], cfg)
    return out, (k, v)


def grouped_decode_attention(q, k, v, *, q_pos, kv_pos, causal=True,
                             window=0, softcap=0.0, chunk_kv=2048,
                             scale=None, score_sum=None, partial=False):
    """Decode-shape (small Sq) attention with grouped GQA: an online
    softmax over ``chunk_kv``-row chunks of the cache (the reference's
    ``_grouped_decode_attention``), each chunk cast to q's dtype as it is
    read.  q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D).  ``scale`` defaults to
    1/√D; ``score_sum(s)`` maps each chunk's raw fp32 scores before they
    are scaled (the head_dim-parallel layout's sum over the group).
    Returns (B,Sq,Hq,D) in q.dtype; with ``partial`` the running state
    instead: the scores' max and the exponentials' sum, (B,Hkv,G,Sq)
    each, and their weighted sum of v, (B,Sq,Hkv,G,D) in fp32."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    ck = _choose_chunk(sk, chunk_kv)
    scale = 1.0 / np.sqrt(dh) if scale is None else scale
    qg = q.reshape(b, sq, hkv, g, dh).float()
    mx = l = acc = None
    for j in range(0, sk, ck):
        kj = k[:, j:j + ck].to(q.dtype).float()
        vj = v[:, j:j + ck].to(q.dtype)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj)
        if score_sum is not None:
            s = score_sum(s)
        s = s * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        diff = q_pos[:, None, None, :, None] \
            - kv_pos[:, None, None, None, j:j + ck]
        mask = torch.ones_like(diff, dtype=torch.bool)
        if causal:
            mask &= diff >= 0
        if window:
            mask &= diff < window
        s = torch.where(mask, s, NEG_INF)
        mb = s.amax(dim=-1)
        e = torch.where(mask, torch.exp(s - mb[..., None]), 0.0)
        wv = torch.einsum("bhgqk,bkhd->bqhgd", e.to(vj.dtype), vj).float()
        if mx is None:
            # the first chunk starts the running state: what the update
            # below gives from (NEG_INF, 0, 0), in fewer ops
            mx, l, acc = mb, e.sum(dim=-1), wv
            continue
        mx_new = torch.maximum(mx, mb)
        c_old = torch.exp(mx - mx_new)
        c_new = torch.exp(mb - mx_new)
        l = l * c_old + e.sum(dim=-1) * c_new
        acc = acc * c_old.permute(0, 3, 1, 2)[..., None] \
            + wv * c_new.permute(0, 3, 1, 2)[..., None]
        mx = mx_new
    if partial:
        return mx, l, acc
    return _normalized(l, acc, q.dtype)


def _normalized(l, acc, dtype):
    """The attention output (B,Sq,Hq,D) of a running state's sum ``l`` and
    weighted sum ``acc``."""
    b, sq, hkv, g, dh = acc.shape
    out = acc / torch.clamp(l.permute(0, 3, 1, 2)[..., None], min=1e-30)
    return out.to(dtype).reshape(b, sq, hkv * g, dh)


def _merge_blocks(mx, l, acc, dtype, mesh, axes):
    """The output of the ranks' running states over their blocks of the
    sequence (``grouped_decode_attention(..., partial=True)``): each
    rescaled to the group's largest max (one all-reduce MAX), then
    summed (one all-reduce SUM of the sums and the weighted sums)."""
    top = shard_ctx.reduce_max(mx, mesh, axes)
    c = torch.exp(mx - top)
    l = l * c
    acc = acc * c.permute(0, 3, 1, 2)[..., None]
    both = shard_ctx.sum_over(torch.cat([l.reshape(-1), acc.reshape(-1)]),
                              mesh, axes)
    return _normalized(both[:l.numel()].reshape(l.shape),
                       both[l.numel():].reshape(acc.shape), dtype)


def seq_start(cache: torch.Tensor) -> int:
    """The global position of a cache's first row: the rank's block's
    start under a context-parallel context, else 0."""
    ctx = shard_ctx.ctx_split()
    return 0 if ctx is None else shard_ctx.group_index(*ctx) * cache.shape[1]


def _cached_attention(q, k, v, q_pos, kv_pos, cfg, *, causal, window,
                      chunk_kv):
    """The rank's query heads ``q`` against a cache as the rank holds it:
    its kv heads, all of them, or (``k.shape[3] < head_dim``) every kv
    head's block of head_dim, whose partial scores are summed over the
    group before the softmax and whose output blocks are gathered.
    ``kv_pos``: the cache rows' positions in the rank's block; under a
    context-parallel context they are moved to the block's start and the
    blocks merged (:func:`_merge_blocks`)."""
    ctx = shard_ctx.ctx_split()
    if ctx is not None:
        kv_pos = kv_pos + seq_start(k)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
              softcap=cfg.attn_softcap, chunk_kv=chunk_kv,
              partial=ctx is not None)

    def attend(q, k, v, **extra):
        got = grouped_decode_attention(q, k, v, **kw, **extra)
        return got if ctx is None else _merge_blocks(*got, q.dtype, *ctx)

    hq_l, dh = q.shape[2], cfg.head_dim
    if k.shape[3] == dh:
        ka, va = _kv_for_q(k, v, hq_l, cfg)
        return attend(q, ka, va)
    mesh, axes = shard_ctx.tp_split()
    r, dd = _tp_index(), k.shape[3]
    split_q = hq_l < cfg.n_heads
    if split_q:                                   # every query head
        q = shard_ctx.gather_from(q, 2, mesh, axes)
    out = attend(
        q[..., r * dd:(r + 1) * dd], k, v, scale=1.0 / np.sqrt(dh),
        score_sum=lambda s: shard_ctx.sum_over(s, mesh, axes))
    out = shard_ctx.gather_from(out, 3, mesh, axes)
    return out[:, :, r * hq_l:(r + 1) * hq_l] if split_q else out


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, max_len, hkv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, x, cache, pos, cfg, *, kind="attn", chunk_kv=2048,
                     donate=False):
    """Single-token decode: x (B,1,d); cache {"k","v"} (B,Smax,Hkv,D); pos
    an int (current length) or a (B,) int tensor of per-row lengths (a
    continuously-batched engine's slots admit at different times, so each
    row carries its own write index / RoPE angle / causal horizon).
    Returns (out, new_cache); the cache passed in is not modified, unless
    ``donate`` (then the new cache is the one passed in, written in
    place)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, None, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    per_row = pos.ndim == 1
    pos_b = pos[:, None] if per_row else pos.reshape(1, 1).expand(b, 1)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_b, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    if not donate:
        k_cache, v_cache = k_cache.clone(), v_cache.clone()
    rows = torch.arange(b, device=x.device)
    smax = k_cache.shape[1]
    at = pos_b[:, 0]
    ctx = shard_ctx.ctx_split()
    if ctx is not None:
        # a row's pos lies in one rank's block: the others write back what
        # their block holds (at a clamped row)
        at = at - seq_start(k_cache)
        inside = ((at >= 0) & (at < smax))[:, None, None]
        at = at.clamp(0, smax - 1)
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        new = cache_part(new, c)[:, 0].to(c.dtype)
        c[rows, at] = new if ctx is None else \
            torch.where(inside, new, c[rows, at])
    kv_pos = torch.arange(smax, device=x.device).expand(b, smax)
    window = cfg.window_size if kind == "attn_local" else 0
    out = _cached_attention(q, k_cache, v_cache, pos_b, kv_pos, cfg,
                            causal=True, window=window, chunk_kv=chunk_kv)
    out = _out_proj(out.reshape(b, 1, -1), p["w_o"], cfg)
    return out, {"k": k_cache, "v": v_cache}


def decode_cross_attention(p, x, enc_kv, cfg):
    """Decode-time cross-attention against a precomputed encoder KV."""
    b = x.shape[0]
    dt = cdtype(cfg)
    dh, hq = cfg.head_dim, cfg.n_heads
    x = _column_input(x, p["w_q"], full=(hq * dh,))
    q = (x @ p["w_q"].to(dt)).reshape(b, 1, -1, dh)
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
    k, v = enc_kv
    sk = k.shape[1]
    pos = torch.zeros((b, 1), dtype=torch.int64, device=x.device)
    kv_pos = torch.arange(sk, device=x.device).expand(b, sk)
    # the reference's flash_attention default: 1,024-row cache chunks
    out = _cached_attention(q, k, v, pos, kv_pos, cfg, causal=False,
                            window=0, chunk_kv=1024)
    return _out_proj(out.reshape(b, 1, -1), p["w_o"], cfg)

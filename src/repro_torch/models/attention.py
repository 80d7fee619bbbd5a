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

The reference pins head and batch shardings with ``shard_ctx.constrain``;
in one process that call has no meaning, so the port drops it.
"""

from __future__ import annotations

import numpy as np
import torch

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

def _project_qkv(p, x, kv_x, cfg):
    dt = cdtype(cfg)
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["w_q"].to(dt)).reshape(b, s, hq, dh)
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    k = (src @ p["w_k"].to(dt)).reshape(b, sk, hkv, dh)
    v = (src @ p["w_v"].to(dt)).reshape(b, sk, hkv, dh)
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
        k = _qk_normalize(k, p["k_norm"])
    return q, k, v


def apply_attention(p, x, cfg, *, kind: str = "attn", kv_x=None,
                    pos_offset=0, block_skip_causal=False):
    """Train/prefill path. kind: attn | attn_local | attn_bidir | attn_cross.
    Returns (out, kv) — kv (k, v) is reused to seed a decode cache."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, kv_x if kind == "attn_cross" else None, cfg)
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
    out = flash_attention(
        q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
        softcap=cfg.attn_softcap, block_skip_causal=block_skip_causal)
    out = out.reshape(b, s, -1) @ p["w_o"].to(cdtype(cfg))
    return out, (k, v)


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, max_len, hkv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, x, cache, pos, cfg, *, kind="attn", chunk_kv=2048):
    """Single-token decode: x (B,1,d); cache {"k","v"} (B,Smax,Hkv,D); pos
    an int (current length) or a (B,) int tensor of per-row lengths (a
    continuously-batched engine's slots admit at different times, so each
    row carries its own write index / RoPE angle / causal horizon).
    Returns (out, new_cache); the cache passed in is not modified."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, None, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    per_row = pos.ndim == 1
    pos_b = pos[:, None] if per_row else pos.reshape(1, 1).expand(b, 1)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_b, cfg.rope_theta)
    k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
    rows = torch.arange(b, device=x.device)
    k_cache[rows, pos_b[:, 0]] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, pos_b[:, 0]] = v_new[:, 0].to(v_cache.dtype)
    smax = k_cache.shape[1]
    kv_pos = torch.arange(smax, device=x.device).expand(b, smax)
    window = cfg.window_size if kind == "attn_local" else 0
    out = flash_attention(
        q, k_cache.to(q.dtype), v_cache.to(q.dtype),
        q_pos=pos_b, kv_pos=kv_pos, causal=True, window=window,
        softcap=cfg.attn_softcap, chunk_q=1, chunk_kv=chunk_kv)
    out = out.reshape(b, 1, -1) @ p["w_o"].to(cdtype(cfg))
    return out, {"k": k_cache, "v": v_cache}


def decode_cross_attention(p, x, enc_kv, cfg):
    """Decode-time cross-attention against a precomputed encoder KV."""
    b = x.shape[0]
    dt = cdtype(cfg)
    dh, hq = cfg.head_dim, cfg.n_heads
    q = (x @ p["w_q"].to(dt)).reshape(b, 1, hq, dh)
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
    k, v = enc_kv
    sk = k.shape[1]
    pos = torch.zeros((b, 1), dtype=torch.int64, device=x.device)
    kv_pos = torch.arange(sk, device=x.device).expand(b, sk)
    out = flash_attention(q, k.to(dt), v.to(dt), q_pos=pos, kv_pos=kv_pos,
                          causal=False, softcap=cfg.attn_softcap, chunk_q=1)
    return out.reshape(b, 1, -1) @ p["w_o"].to(dt)

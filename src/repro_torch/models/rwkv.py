"""RWKV-6 "Finch" [arXiv:2404.05892]: attention-free mixer with
data-dependent decay (ddlerp token shift + LoRA-modulated per-channel decay),
plus the RWKV channel-mix FFN.

The port of ``repro.models.rwkv``.  Projections are full-sequence matmuls;
only the WKV state recurrence loops over time carrying S: (B, H, hs, hs) in
fp32, in chunks that each run in ``torch.utils.checkpoint`` under grad mode
(the reference's rematerialized inner scan: one state kept a chunk for the
backward pass).  Decode carries (x_prev_tm, x_prev_cm, wkv state).

**On a mesh** (a tensor-parallel context, ``shard_ctx.tp_split``) each
block splits where its leaves are the rank's blocks
(``launch.sharding.tp_layout`` keeps a block's all or none; the layer
reads which from their shapes):

* the time mix on heads: the ddlerp half (``mu_x``, ``mu_rwkvg``, the
  LoRA, ``decay_a``) runs whole on every rank; ``w_r``/``w_k``/``w_v``/
  ``w_g`` hold the rank's columns (its heads), ``bonus_u`` and the WKV
  state its heads, ``decay_base``/``decay_b``/``ln_x`` are whole and
  read on the rank's channels only, and ``w_o``'s rows are re-laid out
  as the rank's columns (:func:`_output_columns`);
* the channel mix on d_ff: ``w_k`` holds the rank's columns of d_ff,
  ``w_r`` and ``w_v`` (which carry attention's rule by name) the rank's
  columns of d; the rank's block of ``relu(xk @ w_k)²`` is gathered over
  the group before ``w_v``, and the rank's columns of the output are
  gathered after it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import shard_ctx
from .layers import _dense_init, cdtype, pdtype, remat

_LORA = 32       # ddlerp LoRA rank
_DECAY_LORA = 64


def init_rwkv_time_mix(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    h, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    dt = pdtype(cfg)
    dev = gen.device

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=dev) * scale

    return {
        "mu_x": torch.full((d,), 0.5, dtype=dt, device=dev),
        "mu_rwkvg": torch.full((5, d), 0.5, dtype=dt, device=dev),
        "lora_a": _dense_init(gen, (d, 5 * _LORA), dt),
        "lora_b": normal((5, _LORA, d), 0.01),
        "w_r": _dense_init(gen, (d, d), dt),
        "w_k": _dense_init(gen, (d, d), dt),
        "w_v": _dense_init(gen, (d, d), dt),
        "w_g": _dense_init(gen, (d, d), dt),
        "decay_base": torch.full((d,), -4.0, dtype=dt, device=dev),
        "decay_a": _dense_init(gen, (d, _DECAY_LORA), dt),
        "decay_b": normal((_DECAY_LORA, d), 0.01),
        "bonus_u": normal((h, hs), 0.1),
        "ln_x": torch.ones(d, dtype=dt, device=dev),
        "w_o": _dense_init(gen, (d, d), dt),
    }


def _wkv_chunk(s, r_c, k_c, v_c, w_c, u):
    """The recurrence over one chunk.  r_c, k_c, v_c, w_c: (C,B,H,hs);
    s: (B,H,hs,hs).  Returns (y (C,B,H,hs), s)."""
    ys = []
    bonus = u[None, :, :, None]
    for t in range(r_c.shape[0]):
        akv = k_c[t][..., :, None] * v_c[t][..., None, :]     # outer product
        ys.append(torch.einsum("bhk,bhkv->bhv", r_c[t], s + bonus * akv))
        s = w_c[t][..., None] * s + akv
    return torch.stack(ys), s


def _wkv_scan(r, k, v, w, u, s0, chunk: int = 64):
    """WKV recurrence, chunked for bwd memory.  r,k,v: (B,S,H,hs);
    w: (B,S,H,hs) decay in (0,1); u: (H,hs) bonus; s0: (B,H,hs,hs).
    Returns (y: (B,S,H,hs), sT)."""
    seq = r.shape[1]
    chunk = min(chunk, seq)
    while seq % chunk:
        chunk //= 2
    use_remat = torch.is_grad_enabled()
    xs = [t.transpose(0, 1) for t in (r, k, v, w)]
    s, ys = s0, []
    for i in range(0, seq, chunk):
        args = (s, *(t[i:i + chunk] for t in xs), u)
        y, s = remat(_wkv_chunk, *args) if use_remat else _wkv_chunk(*args)
        ys.append(y)
    return torch.cat(ys).transpose(0, 1), s


def _shifted(x: torch.Tensor, x_prev) -> torch.Tensor:
    """The sequence shifted right by one token: ``x_prev`` (B,1,d), or
    zeros, then x[:, :-1]."""
    first = (x.new_zeros((x.shape[0], 1, x.shape[2])) if x_prev is None
             else x_prev.to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _channels(t: torch.Tensor, n: int) -> torch.Tensor:
    """The rank's block of ``n`` channels of ``t``'s last dim (a view)."""
    return t.narrow(-1, shard_ctx.group_index(*shard_ctx.tp_split()) * n, n)


def apply_rwkv_time_mix(p, x: torch.Tensor, cfg, x_prev=None,
                        wkv_state=None):
    """x: (B,S,d).  x_prev: (B,1,d) last token of previous segment (decode)
    or None (train: internal shift).  Returns (out, (x_last, new_state));
    on a mesh the state holds the rank's heads."""
    dt_ = cdtype(cfg)
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    xx = _shifted(x, x_prev) - x
    # ddlerp: data-dependent token-shift amounts for r,w,k,v,g
    xxx = x + xx * p["mu_x"].to(dt_)
    t5 = torch.tanh(xxx @ p["lora_a"].to(dt_))
    t5 = t5.reshape(b, s, 5, _LORA).permute(2, 0, 1, 3)
    mods = torch.einsum("fbsl,fld->fbsd", t5, p["lora_b"].to(dt_))
    mixed = x[None] + xx[None] * (p["mu_rwkvg"].to(dt_)[:, None, None, :]
                                  + mods)
    dl = p["w_r"].shape[1]                   # the rank's channels
    decay_in = torch.tanh(mixed[1] @ p["decay_a"].to(dt_))
    tp = shard_ctx.tp_split()
    split = tp is not None and dl < d
    if split:
        # the ddlerp half ran whole; each rank reads it on its own heads
        mixed = shard_ctx.copy_to(mixed, *tp)
        decay_in = shard_ctx.copy_to(decay_in, *tp)
    xr, _, xk, xv, xg = mixed
    h = dl // hs
    r = (xr @ p["w_r"].to(dt_)).reshape(b, s, h, hs)
    k = (xk @ p["w_k"].to(dt_)).reshape(b, s, h, hs)
    v = (xv @ p["w_v"].to(dt_)).reshape(b, s, h, hs)
    g = F.silu(xg @ p["w_g"].to(dt_))
    decay_base, decay_b, ln_x = p["decay_base"], p["decay_b"], p["ln_x"]
    if split:
        decay_base, decay_b, ln_x = (_channels(t, dl) for t in
                                     (decay_base, decay_b, ln_x))
    # data-dependent per-channel decay (Finch's signature)
    dec = (decay_base.float() + (decay_in @ decay_b.to(dt_)).float())
    w = torch.exp(-torch.exp(dec)).reshape(b, s, h, hs)
    s0 = (wkv_state.float() if wkv_state is not None
          else torch.zeros((b, h, hs, hs), dtype=torch.float32,
                           device=x.device))
    y, s_t = _wkv_scan(r.float(), k.float(), v.float(), w,
                       p["bonus_u"].float(), s0)
    # per-head groupnorm
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, correction=0)[..., None]
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, dl)
    y = y.to(dt_) * ln_x.to(dt_) * g
    if split:
        out = _output_columns(y, p["w_o"].to(dt_), *tp)
    else:
        out = y @ p["w_o"].to(dt_)
    return out, (x[:, -1:, :], s_t)


def _output_columns(y, w_o, mesh, axes):
    """``y @ w_o`` for ``y`` the rank's channels (B, S, d/m) and ``w_o``
    the rank's rows (d/m, d): one all-to-all re-lays the rank's rows out
    as its columns of all rows, the group gathers ``y``, and then the
    rank's columns of the output.  Each output element is one contraction
    over all of d, as in one process: a row-parallel sum's fp32 reorder,
    amplified by the per-head group norm's 1/σ, moves the train step's
    gradients past 1e-4 of one process's."""
    m = shard_ctx.group_size(mesh, axes)
    dl = w_o.shape[0]
    cols = shard_ctx.all_to_all(w_o.reshape(dl, m, dl).transpose(0, 1),
                                mesh, axes).reshape(m * dl, dl)
    y = shard_ctx.gather_from(y, -1, mesh, axes, sum_grad=True)
    return shard_ctx.gather_from(y @ cols, -1, mesh, axes)


def init_rwkv_channel_mix(gen: torch.Generator, cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = pdtype(cfg)
    dev = gen.device
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=dt, device=dev),
        "w_k": _dense_init(gen, (d, f), dt),
        "w_r": _dense_init(gen, (d, d), dt),
        "w_v": _dense_init(gen, (f, d), dt),
    }


def apply_rwkv_channel_mix(p, x: torch.Tensor, cfg, x_prev=None):
    dt_ = cdtype(cfg)
    xx = _shifted(x, x_prev) - x
    xk = x + xx * p["mu_k"].to(dt_)
    xr = x + xx * p["mu_r"].to(dt_)
    tp = shard_ctx.tp_split()
    split = tp is not None and p["w_k"].shape[1] < cfg.d_ff
    if split:
        xk, xr = shard_ctx.copy_to(xk, *tp), shard_ctx.copy_to(xr, *tp)
    k = torch.square(F.relu(xk @ p["w_k"].to(dt_)))
    if split:
        # every rank reads all of k on its own columns of w_v
        k = shard_ctx.gather_from(k, -1, *tp, sum_grad=True)
    out = torch.sigmoid(xr @ p["w_r"].to(dt_)) * (k @ p["w_v"].to(dt_))
    if split:
        out = shard_ctx.gather_from(out, -1, *tp)
    return out, x[:, -1:, :]


def init_rwkv_state(cfg, batch: int, dtype, device) -> dict:
    h, hs, d = cfg.rwkv_n_heads, cfg.rwkv_head_size, cfg.d_model
    return {"x_prev_tm": torch.zeros((batch, 1, d), dtype=dtype,
                                     device=device),
            "x_prev_cm": torch.zeros((batch, 1, d), dtype=dtype,
                                     device=device),
            "wkv": torch.zeros((batch, h, hs, hs), dtype=torch.float32,
                               device=device)}


__all__ = ["init_rwkv_time_mix", "apply_rwkv_time_mix",
           "init_rwkv_channel_mix", "apply_rwkv_channel_mix",
           "init_rwkv_state"]

"""RWKV-6 "Finch" [arXiv:2404.05892]: attention-free mixer with
data-dependent decay (ddlerp token shift + LoRA-modulated per-channel decay),
plus the RWKV channel-mix FFN.

The port of ``repro.models.rwkv``.  Projections are full-sequence matmuls;
only the WKV state recurrence loops over time carrying S: (B, H, hs, hs) in
fp32, in chunks that each run in ``torch.utils.checkpoint`` under grad mode
(the reference's rematerialized inner scan: one state kept a chunk for the
backward pass).  Decode carries (x_prev_tm, x_prev_cm, wkv state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def apply_rwkv_time_mix(p, x: torch.Tensor, cfg, x_prev=None,
                        wkv_state=None):
    """x: (B,S,d).  x_prev: (B,1,d) last token of previous segment (decode)
    or None (train: internal shift).  Returns (out, (x_last, new_state))."""
    dt_ = cdtype(cfg)
    b, s, d = x.shape
    h, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    xx = _shifted(x, x_prev) - x
    # ddlerp: data-dependent token-shift amounts for r,w,k,v,g
    xxx = x + xx * p["mu_x"].to(dt_)
    t5 = torch.tanh(xxx @ p["lora_a"].to(dt_))
    t5 = t5.reshape(b, s, 5, _LORA).permute(2, 0, 1, 3)
    mods = torch.einsum("fbsl,fld->fbsd", t5, p["lora_b"].to(dt_))
    mixed = x[None] + xx[None] * (p["mu_rwkvg"].to(dt_)[:, None, None, :]
                                  + mods)
    xr, xw, xk, xv, xg = mixed
    r = (xr @ p["w_r"].to(dt_)).reshape(b, s, h, hs)
    k = (xk @ p["w_k"].to(dt_)).reshape(b, s, h, hs)
    v = (xv @ p["w_v"].to(dt_)).reshape(b, s, h, hs)
    g = F.silu(xg @ p["w_g"].to(dt_))
    # data-dependent per-channel decay (Finch's signature)
    dec = (p["decay_base"].float()
           + (torch.tanh(xw @ p["decay_a"].to(dt_))
              @ p["decay_b"].to(dt_)).float())
    w = torch.exp(-torch.exp(dec)).reshape(b, s, h, hs)
    s0 = (wkv_state.float() if wkv_state is not None
          else torch.zeros((b, h, hs, hs), dtype=torch.float32,
                           device=x.device))
    y, s_t = _wkv_scan(r.float(), k.float(), v.float(), w,
                       p["bonus_u"].float(), s0)
    # per-head groupnorm
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, correction=0)[..., None]
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    y = y.to(dt_) * p["ln_x"].to(dt_) * g
    out = y @ p["w_o"].to(dt_)
    return out, (x[:, -1:, :], s_t)


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
    k = torch.square(F.relu(xk @ p["w_k"].to(dt_)))
    out = torch.sigmoid(xr @ p["w_r"].to(dt_)) * (k @ p["w_v"].to(dt_))
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

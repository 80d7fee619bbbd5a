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
order (not bit-reproducible; two contributions onto zero are).  The
reference's distributed path (``shard_map`` over the token stream, the
expert-parallel all-to-all) needs a device mesh and waits with
``launch/sharding.py`` (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

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
    ce_sum = torch.bincount(expert_idx[:, 0], minlength=e).float()

    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(sorted_e, minlength=e)
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


def apply_moe(p, x: torch.Tensor, cfg):
    """x: (B, S, d) → (y: (B, S, d), aux_loss scalar fp32)."""
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


__all__ = ["init_moe", "apply_moe", "top_k", "capacity"]

"""Mamba (selective SSM) block — Jamba's sequence mixer [arXiv:2312.00752,
2403.19887].

The port of ``repro.models.mamba``.  Projections and the depthwise causal
conv are batched over the full sequence; only the diagonal SSM recurrence
runs as a loop over time carrying h: (B, d_inner, d_state) in fp32.  The
loop is cut into chunks, and under grad mode each chunk runs in
``torch.utils.checkpoint`` (the reference's rematerialized inner scan), so
the backward pass keeps one state a chunk, not one a step.  Decode keeps
(conv_state, ssm_state).

**On a mesh** (a tensor-parallel context, ``shard_ctx.tp_split``) the
block splits on d_inner when its leaves are the rank's blocks of it
(``launch.sharding.tp_layout`` keeps them all or none; the layer reads
which from ``in_proj``'s shape).  The conv, ``dt_proj``, ``dt_bias``,
``A_log``, ``D``, the SSM scan and the decode state are the rank's
channels; ``x_proj`` holds the rank's rows, so its product (dt, B, C) is
summed over the group (``shard_ctx.row_split``, over the whole
sequence), and ``out_proj``'s rows are too (``shard_ctx.leave_block``:
reduce-scattered onto the ranks' blocks of the sequence under a
sequence-parallel context, whose entry gathers the sequence before the
conv and the scan read neighbouring tokens).  ``in_proj``'s spec splits
its 2·d_inner columns in contiguous blocks, which are not the rank's x
and z blocks (ranks below |model|/2 hold x's columns, the others z's):
the rank projects its own block and one uneven all-to-all
(:func:`_own_x_and_z`) hands each block of d_inner/|model| columns to
the rank it belongs to — GSPMD's re-layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import shard_ctx
from .layers import _dense_init, cdtype, pdtype, remat


def init_mamba(gen: torch.Generator, cfg) -> dict:
    d, di, n = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    r, dc = cfg.dt_rank, cfg.mamba_d_conv
    dt = pdtype(cfg)
    dev = gen.device
    a = torch.arange(1, n + 1, dtype=dt, device=dev).expand(di, n)
    return {
        "in_proj": _dense_init(gen, (d, 2 * di), dt),
        "conv_w": torch.randn((dc, di), generator=gen, dtype=dt,
                              device=dev) / np.sqrt(dc),
        "conv_b": torch.zeros(di, dtype=dt, device=dev),
        "x_proj": _dense_init(gen, (di, r + 2 * n), dt),
        "dt_proj": _dense_init(gen, (r, di), dt),
        "dt_bias": torch.full((di,), -4.6, dtype=dt, device=dev),
        "A_log": torch.log(a).contiguous(),
        "D": torch.ones(di, dtype=dt, device=dev),
        "out_proj": _dense_init(gen, (di, d), dt),
    }


def _causal_depthwise_conv(xs: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, init_state=None) -> torch.Tensor:
    """xs: (B,S,di); w: (dc,di). Shift-and-add form (dc is tiny).
    init_state: (B, dc-1, di) tail of the previous segment (decode)."""
    dc = w.shape[0]
    pad = init_state if init_state is not None else xs.new_zeros(
        (xs.shape[0], dc - 1, xs.shape[2]))
    xp = torch.cat([pad, xs], dim=1)       # (B, S+dc-1, di), promoted
    s = xs.shape[1]
    out = sum(xp[:, j:j + s, :] * w[j] for j in range(dc))
    return out + b


def _mm(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``a @ w.astype(dt)`` with jnp's promotion: a conv that read an fp32
    decode state under bf16 compute stays fp32 through the projections."""
    return a @ w.to(torch.promote_types(a.dtype, dt))


def _ssm_chunk(h, dt_c, x_c, b_c, c_c, a):
    """The recurrence over one chunk.  dt_c, x_c: (C,B,di); b_c, c_c:
    (C,B,N); h: (B,di,N).  Returns (y (C,B,di), h)."""
    ys = []
    for t in range(dt_c.shape[0]):
        da = torch.exp(dt_c[t][..., None] * a)                  # (B,di,N)
        h = da * h + (dt_c[t] * x_c[t])[..., None] * b_c[t][:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_c[t]))
    return torch.stack(ys), h


def _ssm_scan(dt_full, x_full, b_full, c_full, a, h0, chunk: int = 128):
    """Diagonal selective-SSM recurrence, chunked for bwd memory.

    dt_full, x_full: (B,S,di); b_full, c_full: (B,S,N); a: (di,N);
    h0: (B,di,N).  Returns (y: (B,S,di), hT)."""
    s = dt_full.shape[1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    use_remat = torch.is_grad_enabled()
    seq = [t.transpose(0, 1) for t in (dt_full, x_full, b_full, c_full)]
    h, ys = h0, []
    for i in range(0, s, chunk):
        args = (h, *(t[i:i + chunk] for t in seq), a)
        y, h = remat(_ssm_chunk, *args) if use_remat else _ssm_chunk(*args)
        ys.append(y)
    return torch.cat(ys).transpose(0, 1), h


def _own_x_and_z(xz: torch.Tensor, mesh, axes):
    """The rank's x and z blocks from its block of ``in_proj``'s product.

    ``xz`` (B, S, 2w) holds columns [2rw, 2rw + 2w) of the 2·d_inner
    (``m`` ranks, ``w`` = d_inner/m): blocks ``2r`` and ``2r + 1`` of the
    ``2m`` blocks of ``w``, where block ``k < m`` is rank ``k``'s x and
    block ``k ≥ m`` rank ``k − m``'s z.  Each goes to its rank in one
    ``all_to_all_single`` of uneven chunks; the rank receives its x from
    rank ``r // 2`` and its z from rank ``(m + r) // 2``, in that (rank)
    order.  Returns (x, z), each (B, S, w)."""
    m = shard_ctx.group_size(mesh, axes)
    r = shard_ctx.group_index(mesh, axes)
    b, s, two_w = xz.shape
    w = two_w // 2
    blocks = xz.reshape(b, s, 2, w).movedim(2, 0)           # (2, B, S, w)
    dest = [(2 * r + j) % m for j in (0, 1)]
    order = sorted((0, 1), key=dest.__getitem__)
    send, recv = [0] * m, [0] * m
    for j in (0, 1):
        send[dest[j]] += 1
    recv[r // 2] += 1
    recv[(m + r) // 2] += 1
    got = shard_ctx.exchange_blocks(blocks[list(order)], mesh, axes, send,
                                    recv)
    return got[0], got[1]


def apply_mamba(p, x: torch.Tensor, cfg, state=None):
    """x: (B,S,d) (the rank's block of S under a sequence-parallel
    context). state: None (train) or {"conv","ssm"} for segment carry
    (the rank's channels on a mesh).  Returns (out, new_state)."""
    dt_ = cdtype(cfg)
    di, n = cfg.mamba_d_inner, cfg.mamba_d_state
    r = cfg.dt_rank
    tp = shard_ctx.tp_split()
    split = tp is not None and p["in_proj"].shape[1] < 2 * di
    x = shard_ctx.enter_block(x, split)
    b, s, _ = x.shape
    if split:
        xs_, z = _own_x_and_z(x @ p["in_proj"].to(dt_), *tp)
        di = xs_.shape[-1]
    else:
        xz = x @ p["in_proj"].to(dt_)
        xs_, z = torch.chunk(xz, 2, dim=-1)
    conv_in = state["conv"] if state is not None else None
    xc = _causal_depthwise_conv(xs_, p["conv_w"].to(dt_),
                                p["conv_b"].to(dt_), conv_in)
    xc = F.silu(xc)
    if split:
        # the rank's rows of x_proj: (dt, B, C) summed over the group,
        # which every rank then reads on its own channels
        dbc = shard_ctx.copy_to(shard_ctx.row_split(
            xc, p["x_proj"].to(torch.promote_types(xc.dtype, dt_)), *tp),
            *tp)
    else:
        dbc = _mm(xc, p["x_proj"], dt_)
    dt_raw, b_ssm, c_ssm = torch.split(dbc, [r, n, n], dim=-1)
    dts = F.softplus(_mm(dt_raw, p["dt_proj"], dt_).float()
                     + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    h0 = (state["ssm"].float() if state is not None
          else torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    y, h_t = _ssm_scan(dts, xc.float(), b_ssm.float(), c_ssm.float(), a, h0)
    y = (y + xc.float() * p["D"].float()).to(dt_)
    y = y * F.silu(z)
    out = shard_ctx.leave_block(y @ p["out_proj"].to(dt_), split)
    new_state = None
    if state is not None:
        dc = cfg.mamba_d_conv
        tail = torch.cat([state["conv"], xs_], dim=1)[:, -(dc - 1):, :]
        new_state = {"conv": tail.to(state["conv"].dtype),
                     "ssm": h_t.to(state["ssm"].dtype)}
    return out, new_state


def init_mamba_state(cfg, batch: int, dtype, device) -> dict:
    di, n, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, n), dtype=torch.float32,
                               device=device)}


__all__ = ["init_mamba", "apply_mamba", "init_mamba_state"]

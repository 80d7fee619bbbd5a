"""Shared model layers: norms, embeddings, positional encodings, MLPs, head.

The port of ``repro.models.layers``.

Conventions
-----------
* params are nested dicts of tensors; every init function draws from an
  explicit ``torch.Generator`` and makes its tensors on that generator's
  device, so one seed gives one model on the card or on the CPU.
* compute dtype (``cfg.dtype``, bf16 at full width) is applied at use;
  params stay in ``cfg.param_dtype`` (fp32 master copies).  An embedding
  lookup gathers the rows first and casts them after, which is the same
  elementwise cast on fewer rows.
* norm statistics, RoPE angles and the loss's logsumexp are fp32
  regardless of compute dtype.
* under a tensor-parallel context (``shard_ctx.tp_split``) a layer handed
  the rank's block of a leaf splits its compute: the embedding looks up
  its vocab range and sums over the group, the MLP splits d_ff (columns,
  then rows, one sum after ``w_down``), ``logits_fn`` on the rank's
  vocab block returns the rank's block of the logits (no gather; the
  final softcap is elementwise), and ``chunked_xent`` takes the
  logsumexp over the vocab shards (vocab-parallel loss: the group's
  largest logit, then its sums of the shifted exponentials and of the
  gold logit, which one rank's block holds).  Under a sequence-parallel
  context (``shard_ctx.seq_split``) the embedding reduce-scatters its
  rows onto the rank's block of the sequence, the MLP gathers the
  sequence at entry and reduce-scatters after ``w_down``
  (``shard_ctx.enter_block`` / ``leave_block``), and :func:`head_input`
  gathers the sequence before the head.
* the reference's gradient-dtype boundary (``_grad_same_dtype`` before
  every norm: the fp32 cotangent of the norm statistics is cast back to the
  primal's dtype, so the backward residual stream stays bf16) needs no
  ``autograd.Function`` here: the backward of ``x.float()`` already returns
  the gradient in ``x``'s dtype.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import shard_ctx


# what a remat region runs through: None for ``torch.utils.checkpoint``,
# else the function set by ``remat_through`` (the cost counter's replay)
_REMAT = contextvars.ContextVar("remat", default=None)


def remat(fn, *args):
    """``fn(*args)`` in ``torch.utils.checkpoint`` (not reentrant): the
    reference's ``jax.checkpoint``.  Every remat region of the port (a
    unit of the stack, a chunk of the Mamba or RWKV scan, a chunk of the
    loss) goes through here, so that :func:`remat_through` reaches all of
    them."""
    hook = _REMAT.get()
    if hook is not None:
        return hook(fn, *args)
    return checkpoint(fn, *args, use_reentrant=False)


def region(fn, *args):
    """``fn(*args)`` where no gradient is taken (a unit of the mesh prefill
    or decode): run as it is, or through :func:`remat_through`'s hook, so
    that the cost counter replays it as it replays a remat region."""
    hook = _REMAT.get()
    return hook(fn, *args) if hook is not None else fn(*args)


@contextlib.contextmanager
def remat_through(hook):
    """Inside, every :func:`remat` region of this thread runs as
    ``hook(fn, *args)`` (``roofline.op_cost``'s replay)."""
    token = _REMAT.set(hook)
    try:
        yield
    finally:
        _REMAT.reset(token)


def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def pad_vocab(vocab: int, multiple: int = 2048) -> int:
    """Pad vocabulary so the vocab-parallel dimension divides the mesh
    (standard practice: Megatron pads to a multiple of TP×128)."""
    return -(-vocab // multiple) * multiple


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg, d: int, device) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, dtype=pdtype(cfg), device=device),
                "bias": torch.zeros(d, dtype=pdtype(cfg), device=device)}
    return {"scale": torch.ones(d, dtype=pdtype(cfg), device=device)}


def apply_norm(p, x: torch.Tensor, cfg, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:            # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings & positions
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * scale


def init_embedding(gen: torch.Generator, cfg) -> dict:
    v = pad_vocab(cfg.vocab_size)
    emb = torch.randn((v, cfg.d_model), generator=gen, dtype=pdtype(cfg),
                      device=gen.device) * 0.02
    p = {"embedding": emb}
    if cfg.pos_embedding == "learned":
        p["pos_embedding"] = torch.zeros((cfg.max_position, cfg.d_model),
                                         dtype=pdtype(cfg),
                                         device=gen.device)
    return p


def _positions(pos_offset, s: int, device) -> torch.Tensor:
    """(S,) positions from a scalar start, or (B, S) from (B,) starts."""
    po = torch.as_tensor(pos_offset, device=device)
    return (po[:, None] if po.ndim == 1 else po) + torch.arange(
        s, device=device)


def embed_tokens(p, tokens: torch.Tensor, cfg, pos_offset=0) -> torch.Tensor:
    """``pos_offset``: scalar start position, or (B,) int per-row starts
    (continuous batching — each decode slot sits at its own position)."""
    dt = cdtype(cfg)
    emb = p["embedding"]
    tp = shard_ctx.tp_split()
    if tp is not None and emb.shape[0] < pad_vocab(cfg.vocab_size):
        x = shard_ctx.vocab_lookup(emb, tokens, *tp, dtype=dt)
    else:
        x = shard_ctx.leave_block(emb[tokens].to(dt), False)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.pos_embedding == "learned":
        pos = _positions(pos_offset, tokens.shape[-1], x.device)
        x = x + p["pos_embedding"][shard_ctx.seq_block(pos)].to(dt)
    return x


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int.  Split halves (the
    reference's form), angles in fp32."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, d_model=None, d_ff=None) -> dict:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    dt = pdtype(cfg)
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": _dense_init(gen, (d, f), dt),
                "w_up": _dense_init(gen, (d, f), dt),
                "w_down": _dense_init(gen, (f, d), dt)}
    return {"w_up": _dense_init(gen, (d, f), dt),
            "w_down": _dense_init(gen, (f, d), dt)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    # the rank's d_ff columns, then its rows, one sum
    split = shard_ctx.tp_split() is not None and \
        p["w_down"].shape[0] < cfg.d_ff
    x = shard_ctx.enter_block(x, split)
    if "w_gate" in p:
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu(g) if cfg.act == "swiglu" else _gelu(g)
        h = act * u
    else:
        h = _gelu(x @ p["w_up"].to(dt))
    return shard_ctx.leave_block(h @ p["w_down"].to(dt), split)


# ---------------------------------------------------------------------------
# output head
# ---------------------------------------------------------------------------

def init_lm_head(gen: torch.Generator, cfg) -> dict:
    if cfg.tie_embeddings:
        return {}
    v = pad_vocab(cfg.vocab_size)
    return {"w_head": _dense_init(gen, (cfg.d_model, v), pdtype(cfg))}


def softcap(logits: torch.Tensor, c: float) -> torch.Tensor:
    return torch.tanh(logits / c) * c if c else logits


def _vocab_split(head_p, emb_p, cfg) -> bool:
    """Whether the head (or the tied embedding) is the rank's block of
    the vocab under a tensor-parallel context."""
    if shard_ctx.tp_split() is None:
        return False
    rows = (emb_p["embedding"].shape[0] if cfg.tie_embeddings
            else head_p["w_head"].shape[1])
    return rows < pad_vocab(cfg.vocab_size)


def head_input(head_p, emb_p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The head's input from the final norm's output ``x``: under a
    sequence-parallel context the whole sequence, gathered from the ranks'
    blocks (``shard_ctx.enter_block``: where the head is the rank's block
    of the vocab the backward reduce-scatters the blocks' parts of the
    gradient, so :func:`logits_fn` reads it as it is); ``x`` otherwise."""
    if shard_ctx.seq_split() is None:
        return x
    return shard_ctx.enter_block(x, _vocab_split(head_p, emb_p, cfg))


def logits_fn(head_p, emb_p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits of ``x``: the rank's block of the vocab where the head (or
    the tied embedding) is the rank's block of it, ``x`` then read through
    ``shard_ctx.copy_to`` (its gradient summed over the blocks) unless a
    sequence-parallel context's gather (:func:`head_input`) sums it."""
    dt = cdtype(cfg)
    if cfg.tie_embeddings:
        w = emb_p["embedding"].to(dt).T
    else:
        w = head_p["w_head"].to(dt)
    if _vocab_split(head_p, emb_p, cfg) and shard_ctx.seq_split() is None:
        x = shard_ctx.copy_to(x, *shard_ctx.tp_split())
    return softcap(x @ w, cfg.final_softcap)


def _xent_chunk(head_p, emb_p, xc, lc, mc, cfg) -> torch.Tensor:
    """Σ mask · (logsumexp − gold logit) over one (B, C) chunk, fp32."""
    logits = logits_fn(head_p, emb_p, xc, cfg).float()
    tp = shard_ctx.tp_split()
    if tp is not None and logits.shape[-1] < pad_vocab(cfg.vocab_size):
        return (_VocabParallelXent.apply(logits, lc, *tp) * mc).sum()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None])[..., 0]
    return ((lse - gold) * mc).sum()


class _VocabParallelXent(torch.autograd.Function):
    """Per row, logsumexp − gold logit of rows whose ``logits`` are the
    rank's block of the vocab (vocab-parallel loss): the group's largest
    logit is the shift, and the shifted exponentials' sum and the gold
    logit (zero on every rank but the one whose block holds the label) are
    summed over the group in one all-reduce.  Its backward is the unsplit
    loss's, ``g · (exp(logits − lse) − onehot(label))`` on the rank's
    block, with no sum: the loss is the same on every rank of the group."""

    @staticmethod
    def forward(ctx, logits, labels, mesh, axes):
        n = logits.shape[-1]
        local = labels - shard_ctx.group_index(mesh, axes) * n
        inside = (local >= 0) & (local < n)
        local = torch.where(inside, local, 0)
        gold = logits.gather(-1, local[..., None])[..., 0]
        m = shard_ctx.reduce_max(logits.amax(dim=-1), mesh, axes)
        sum_exp, gold = shard_ctx.reduce_sum(torch.stack([
            torch.exp(logits - m[..., None]).sum(dim=-1),
            torch.where(inside, gold, 0.0)]), mesh, axes)
        lse = m + torch.log(sum_exp)
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        grad = g[..., None] * torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, local[..., None],
                          torch.where(inside, -g, 0.0)[..., None])
        return grad, None, None, None


def chunked_xent(head_p, emb_p, x: torch.Tensor, labels, mask, cfg,
                 chunk: int = 512) -> torch.Tensor:
    """Next-token cross-entropy without materializing fp32 (B,S,V) logits.

    Loops over sequence chunks; per-chunk logits stay (B,C,V) in compute
    dtype, logsumexp in fp32.  Under grad mode each chunk runs in
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so its
    logits are recomputed in the backward pass instead of being kept for
    the whole sequence."""
    b, s, _ = x.shape
    labels = torch.as_tensor(labels, device=x.device).long()
    mask = torch.as_tensor(mask, device=x.device).float()
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    use_remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        args = (head_p, emb_p, x[:, i:i + chunk], labels[:, i:i + chunk],
                mask[:, i:i + chunk], cfg)
        tot = tot + (remat(_xent_chunk, *args) if use_remat
                     else _xent_chunk(*args))
        cnt = cnt + mask[:, i:i + chunk].sum()
    return tot / torch.clamp(cnt, min=1.0)


__all__ = ["cdtype", "pdtype", "pad_vocab", "init_norm", "apply_norm",
           "init_embedding", "embed_tokens", "rope_frequencies",
           "apply_rope", "init_mlp", "apply_mlp", "init_lm_head",
           "logits_fn", "head_input", "softcap", "chunked_xent", "remat",
           "region", "remat_through"]

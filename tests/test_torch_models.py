"""``repro_torch.models`` against ``repro.models`` — mirrors
``tests/test_models_smoke.py`` on the six ported architectures.

Parameters come from the JAX ``init_model(PRNGKey(0))`` and are carried
into the port by ``convert.lm_params`` (the config by
``convert.model_config``), so both packages compute on the same fp32
weights; tokens and encoder frames come from numpy with a seed.  Hidden
states, logits, decode states and decode steps are held to 1e-4 of the
largest reference magnitude (the reference's own decode-consistency
bound, ``tests/test_models_smoke.py:65``).  The four architectures with
MoE, Mamba or RWKV blocks are not ported yet and must raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_model as jinit_model
from repro.models import prefill as jprefill
from repro.models.layers import apply_rope as japply_rope
from repro.models.layers import logits_fn as jlogits_fn
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_model, prefill)
from repro_torch.models.layers import apply_rope, logits_fn, pad_vocab

PORTED = ["yi_6b", "gemma2_2b", "phi3_mini_3_8b", "llama3_2_1b",
          "whisper_tiny", "chameleon_34b"]
UNPORTED = [a for a in ARCH_IDS if a not in PORTED]
TOL = 1e-4


def rel(a, b) -> float:
    """max|a - b| / max|b|."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t2n(x) -> np.ndarray:
    return x.detach().cpu().numpy()


_SETUPS = {}


def setup(arch):
    """(jax cfg, jax params, port cfg, port params), memoized."""
    if arch not in _SETUPS:
        jcfg = jget_config(arch, smoke=True)
        jp = jinit_model(jax.random.PRNGKey(0), jcfg)
        tcfg = convert.model_config(jcfg)
        tp = convert.lm_params(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
        _SETUPS[arch] = (jcfg, jp, tcfg, tp)
    return _SETUPS[arch]


def make_batch(cfg, b, s, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                    dtype=np.int32)}
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return batch


def jbatch(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_states_close(tstate, jstate) -> None:
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert jflat
    for path, leaf in jflat:
        t = tstate
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == tuple(leaf.shape), path
        assert rel(t2n(t), leaf) < TOL, path


@pytest.mark.parametrize("arch", PORTED)
def test_forward_and_logits_match_jax(arch):
    jcfg, jp, tcfg, tp = setup(arch)
    b, s = 2, 32
    batch = make_batch(jcfg, b, s)
    hj, auxj = jforward(jp, jbatch(batch), jcfg)
    lj = jlogits_fn(jp["head"], jp["embed"], hj, jcfg)
    with torch.no_grad():
        ht, auxt = forward(tp, batch, tcfg)
        lt = logits_fn(tp["head"], tp["embed"], ht, tcfg)
    assert ht.shape == (b, s, tcfg.d_model)
    assert lt.shape == (b, s, pad_vocab(tcfg.vocab_size))
    assert bool(torch.isfinite(ht).all()) and float(auxt) == float(auxj)
    assert rel(t2n(ht), hj) < TOL
    assert rel(t2n(lt), lj) < TOL


@pytest.mark.parametrize("arch", PORTED)
def test_decode_consistency_and_jax_decode(arch):
    """prefill + decode_step must equal the forward at position S (the
    reference's check), and the port's prefill state and decode step the
    JAX package's."""
    jcfg, jp, tcfg, tp = setup(arch)
    b, s = 2, 16
    full = make_batch(jcfg, b, s + 1)
    pre = {k: (v[:, :s] if k == "tokens" else v) for k, v in full.items()}
    if jcfg.family == "encdec":
        pre["enc_frames"] = full["enc_frames"][:, :s]
        full = dict(full, enc_frames=pre["enc_frames"])
    nxt = full["tokens"][:, s:s + 1]
    with torch.no_grad():
        h_full, _ = forward(tp, full, tcfg)
        st = init_decode_state(tcfg, b, 32, torch.float32, enc_len=s,
                               device="cpu")
        st_before = {k: v.clone() for k, v in st["b0"].items()}
        h_last, st2 = prefill(tp, pre, tcfg, st)
        hd, st3 = decode_step(tp, nxt, tcfg, st2, s)
    for k, v in st["b0"].items():          # the state passed in is kept
        assert torch.equal(v, st_before[k])
    err = float((hd[:, 0] - h_full[:, s]).abs().max())
    assert err / float(h_full.abs().max()) < TOL, f"{arch}: decode diverges"

    jst = jinit_decode_state(jcfg, b, 32, jnp.float32, enc_len=s)
    jh_last, jst2 = jprefill(jp, jbatch(pre), jcfg, jst)
    jhd, jst3 = jdecode_step(jp, jnp.asarray(nxt), jcfg, jst2, jnp.int32(s))
    assert rel(t2n(h_last), jh_last) < TOL
    assert_states_close(st2, jst2)
    assert rel(t2n(hd), jhd) < TOL
    assert_states_close(st3, jst3)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "whisper_tiny"])
def test_per_row_decode_positions_match_jax(arch):
    """Continuous batching: each row decodes at its own position (RoPE
    angle, cache index, learned-position lookup, causal horizon)."""
    jcfg, jp, tcfg, tp = setup(arch)
    b, s = 3, 12
    batch = make_batch(jcfg, b, s, seed=3)
    pos = np.array([4, 12, 7], np.int32)
    tok = np.random.default_rng(4).integers(0, jcfg.vocab_size, (b, 1),
                                            dtype=np.int32)
    jst = jinit_decode_state(jcfg, b, 24, jnp.float32, enc_len=s)
    _, jst = jprefill(jp, jbatch(batch), jcfg, jst)
    jh, jst = jdecode_step(jp, jnp.asarray(tok), jcfg, jst, jnp.asarray(pos))
    with torch.no_grad():
        st = init_decode_state(tcfg, b, 24, torch.float32, enc_len=s,
                               device="cpu")
        _, st = prefill(tp, batch, tcfg, st)
        h, st = decode_step(tp, tok, tcfg, st, torch.as_tensor(pos))
    assert rel(t2n(h), jh) < TOL
    assert_states_close(st, jst)


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_architectures_raise(arch):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        init_model(0, cfg, device="cpu")
    jcfg = jget_config(arch, smoke=True)
    if jcfg.n_experts:
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
    jp = jax.tree.map(np.asarray, jinit_model(jax.random.PRNGKey(0), jcfg))
    tp = convert.lm_params(jp, cfg, device="cpu")   # carried, not run
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        forward(tp, make_batch(cfg, 1, 8), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        init_decode_state(cfg, 1, 8, device="cpu")


def test_block_skip_causal_matches_masked():
    """The triangular block enumeration equals the masked-full baseline
    (and the JAX package's)."""
    jcfg, jp, tcfg, tp = setup("llama3_2_1b")
    batch = make_batch(tcfg, 2, 64)
    with torch.no_grad():
        h0, _ = forward(tp, batch, tcfg, skip_causal=False)
        h1, _ = forward(tp, batch, tcfg, skip_causal=True)
    assert float((h0 - h1).abs().max()) < 1e-4
    hj, _ = jforward(jp, jbatch(batch), jcfg, skip_causal=True)
    assert rel(t2n(h1), hj) < TOL


def test_block_skip_visits_fewer_keys(monkeypatch):
    """With several query chunks, the skip variant reads fewer key
    positions than the masked one (it skips the fully masked blocks)."""
    from repro_torch.models import attention

    seen = []
    real = torch.einsum

    def spy(eq, *ops):
        if eq == "bqhgd,bkhd->bhgqk":
            seen.append(ops[1].shape[1])
        return real(eq, *ops)

    monkeypatch.setattr(attention.torch, "einsum", spy)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 64, 4, 8), generator=g)
    k = torch.randn((1, 64, 2, 8), generator=g)
    v = torch.randn((1, 64, 2, 8), generator=g)
    pos = torch.arange(64)[None]
    kw = dict(q_pos=pos, kv_pos=pos, chunk_q=16, chunk_kv=16)
    y0 = attention.flash_attention(q, k, v, **kw)
    masked = sum(seen)
    seen.clear()
    y1 = attention.flash_attention(q, k, v, block_skip_causal=True, **kw)
    assert sum(seen) < masked and seen == [16, 32, 48, 64]
    assert float((y0 - y1).abs().max()) < 1e-5


def test_gemma2_softcap_and_window_active():
    jcfg, jp, tcfg, tp = setup("gemma2_2b")
    batch = make_batch(tcfg, 1, 96)       # > window 64 so local != global
    with torch.no_grad():
        h, _ = forward(tp, batch, tcfg)
        logits = logits_fn(tp["head"], tp["embed"], h, tcfg)
        # the window matters: without it the hidden states differ
        h_nowin, _ = forward(tp, batch, dataclasses.replace(
            tcfg, window_size=0))
    assert bool(torch.isfinite(h).all())
    assert float(logits.abs().max()) <= tcfg.final_softcap + 1e-3
    assert float((h - h_nowin).abs().max()) > 1e-3
    hj, _ = jforward(jp, jbatch(batch), jcfg)
    lj = jlogits_fn(jp["head"], jp["embed"], hj, jcfg)
    assert rel(t2n(h), hj) < TOL and rel(t2n(logits), lj) < TOL


def test_prefill_skip_causal_matches_masked():
    """The triangular prefill gives the same hidden state and decode cache
    as the masked-full prefill, and the JAX package's."""
    jcfg, jp, tcfg, tp = setup("llama3_2_1b")
    batch = make_batch(tcfg, 2, 64)
    with torch.no_grad():
        st = init_decode_state(tcfg, 2, 96, torch.float32, device="cpu")
        h0, st0 = prefill(tp, batch, tcfg, st, skip_causal=False)
        h1, st1 = prefill(tp, batch, tcfg, st, skip_causal=True)
    assert float((h0 - h1).abs().max()) < 1e-4
    for k in ("k", "v"):
        assert float((st0["b0"][k] - st1["b0"][k]).abs().max()) < 1e-4
    jst = jinit_decode_state(jcfg, 2, 96, jnp.float32)
    jh, jst1 = jprefill(jp, jbatch(batch), jcfg, jst, skip_causal=True)
    assert rel(t2n(h1), jh) < TOL
    assert_states_close(st1, jst1)


def test_whisper_encoder_decoder_cross_kv():
    """Whisper's encoder-decoder: the prefill fills the cross K/V from the
    encoder frames (held to the JAX package's), and decode reads them."""
    jcfg, jp, tcfg, tp = setup("whisper_tiny")
    b, s = 2, 8
    batch = make_batch(tcfg, b, s, seed=5)
    with torch.no_grad():
        st = init_decode_state(tcfg, b, 16, torch.float32, enc_len=s,
                               device="cpu")
        _, st1 = prefill(tp, batch, tcfg, st)
        frames2 = dict(batch, enc_frames=batch["enc_frames"] * 2.0)
        _, st2 = prefill(tp, frames2, tcfg, st)
        tok = batch["tokens"][:, :1]
        h1, _ = decode_step(tp, tok, tcfg, st1, s)
        h2, _ = decode_step(tp, tok, tcfg, st2, s)
    assert float(st1["b0"]["ck"].abs().max()) > 0
    assert float((h1 - h2).abs().max()) > 1e-4      # decode reads the encoder
    jst = jinit_decode_state(jcfg, b, 16, jnp.float32, enc_len=s)
    _, jst1 = jprefill(jp, jbatch(batch), jcfg, jst)
    jh1, _ = jdecode_step(jp, jnp.asarray(tok), jcfg, jst1, jnp.int32(s))
    assert_states_close(st1, jst1)
    assert rel(t2n(h1), jh1) < TOL


def test_rope_split_halves_and_gelu_tanh_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    want = japply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    got = apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 500000.0)
    assert rel(t2n(got), want) < 1e-5
    from repro_torch.models.layers import _gelu

    g = rng.standard_normal(1000).astype(np.float32) * 4
    assert rel(t2n(_gelu(torch.as_tensor(g))),
               jax.nn.gelu(jnp.asarray(g))) < 1e-6


def test_init_model_from_a_generator():
    """Weights come from an explicit generator on the given device: the
    same seed gives the same tensors, and the tree has the JAX package's
    structure and shapes."""
    cfg = get_config("gemma2_2b", smoke=True)
    a = init_model(torch.Generator("cpu").manual_seed(3), cfg)
    b = init_model(3, cfg, device="cpu")
    jp = jinit_model(jax.random.PRNGKey(0), jget_config("gemma2_2b",
                                                        smoke=True))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        ta, tb = a, b
        for key in path:
            ta, tb = ta[key.key], tb[key.key]
        assert tuple(ta.shape) == tuple(leaf.shape), path
        assert ta.dtype == torch.float32 and torch.equal(ta, tb), path


def test_convert_carries_config_and_checks_unit_stacks():
    jcfg = jget_config("whisper_tiny", smoke=True)
    tcfg = convert.model_config(jcfg)
    for f in dataclasses.fields(jcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg == get_config("whisper_tiny", smoke=True)
    jp = jax.tree.map(np.asarray, jinit_model(jax.random.PRNGKey(0), jcfg))
    bad = dict(jp, units=jax.tree.map(lambda a: a[:1], jp["units"]))
    with pytest.raises(ValueError, match="stacks 1 units"):
        convert.lm_params(bad, tcfg, device="cpu")

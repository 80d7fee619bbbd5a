"""``repro_torch.models`` against ``repro.models`` — mirrors
``tests/test_models_smoke.py`` on all ten architectures.

Parameters come from the JAX ``init_model(PRNGKey(0))`` and are carried
into the port by ``convert.lm_params`` (the config by
``convert.model_config``), so both packages compute on the same fp32
weights; tokens and encoder frames come from numpy with a seed.  Hidden
states, logits, decode states and decode steps are held to 1e-4 of the
largest reference magnitude (the reference's own decode-consistency
bound, ``tests/test_models_smoke.py:65``); the MoE architectures' decode
runs with capacity raised so no token drops, as the reference's test
does.  The MoE router's expert choices (top-k with ties to the lower
index, the stable packing) equal the reference's.
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

PORTED = list(ARCH_IDS)
# ported in the train slice: MoE, Mamba and RWKV blocks
NEW_FAMILIES = ["moonshot_v1_16b_a3b", "grok_1_314b", "rwkv6_7b",
                "jamba_1_5_large_398b"]
TOL = 1e-4


def rel(a, b) -> float:
    """max|a - b| / max|b|."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t2n(x) -> np.ndarray:
    return x.detach().cpu().numpy()


_SETUPS = {}


def setup(arch, no_drops=False):
    """(jax cfg, jax params, port cfg, port params), memoized; with
    ``no_drops`` an MoE config's capacity is raised so no token drops."""
    if (arch, no_drops) not in _SETUPS:
        jcfg = jget_config(arch, smoke=True)
        if no_drops and jcfg.n_experts:
            jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        jp = jinit_model(jax.random.PRNGKey(0), jcfg)
        tcfg = convert.model_config(jcfg)
        tp = convert.lm_params(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
        _SETUPS[arch, no_drops] = (jcfg, jp, tcfg, tp)
    return _SETUPS[arch, no_drops]


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
    assert bool(torch.isfinite(ht).all())
    if jcfg.n_experts:          # the Switch aux loss of every MoE block
        assert float(auxj) > 0 and rel(float(auxt), float(auxj)) < TOL
    else:
        assert float(auxt) == float(auxj)
    assert rel(t2n(ht), hj) < TOL
    assert rel(t2n(lt), lj) < TOL


@pytest.mark.parametrize("arch", PORTED)
def test_decode_consistency_and_jax_decode(arch):
    """prefill + decode_step must equal the forward at position S (the
    reference's check), and the port's prefill state and decode step the
    JAX package's."""
    jcfg, jp, tcfg, tp = setup(arch, no_drops=True)
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


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_unported_architectures_raise(arch):
    """The four architectures that raised before the train slice now build
    with the reference's parameter tree, and a block kind the spine does
    not know raises ``ValueError`` naming it (at init and at apply)."""
    cfg = get_config(arch, smoke=True)
    tp = init_model(0, cfg, device="cpu")
    jp = jinit_model(jax.random.PRNGKey(0), jget_config(arch, smoke=True))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == tuple(leaf.shape), path
    mixer, ffn = cfg.unit_pattern[0]
    for pattern in ((("conv", ffn),), ((mixer, "glu"),)):
        bad = dataclasses.replace(cfg, unit_pattern=pattern,
                                  n_layers=len(pattern))
        kind = pattern[0][0] if pattern[0][0] == "conv" else "glu"
        with pytest.raises(ValueError, match=kind):
            init_model(0, bad, device="cpu")
        one = dataclasses.replace(cfg, n_layers=len(cfg.unit_pattern))
        params = init_model(0, one, device="cpu")
        with pytest.raises(ValueError, match=kind):
            with torch.no_grad():
                forward(params, make_batch(cfg, 1, 8),
                        dataclasses.replace(one, unit_pattern=pattern * len(
                            cfg.unit_pattern)))


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "grok_1_314b"])
def test_moe_routing_matches_jax(arch):
    """The router's top-k (ties to the lower index) and the stable packing:
    expert indices, slots, token order and gate weights equal the
    reference's, and the combined output within 1e-4; the packing at
    capacity 8, so tokens overflow into the sink row and drop."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe

    jcfg, jp, tcfg, tp = setup(arch)
    rng = np.random.default_rng(11)
    xt = rng.standard_normal((48, tcfg.d_model)).astype(np.float32)
    router = np.array(jp["units"]["b0"]["ffn"]["router"][0])
    cap = moe.capacity(48, tcfg)
    assert cap == max(8, -(-int(np.ceil(48 * jcfg.top_k / jcfg.n_experts
                                        * jcfg.capacity_factor)) // 8) * 8)
    jout = jmoe._route_and_pack(jnp.asarray(xt), jnp.asarray(router), jcfg,
                                8)
    tout = moe._route_and_pack(torch.as_tensor(xt), torch.as_tensor(router),
                               tcfg, 8)
    for name, a, b in zip(("buf", "slot", "tok_of", "w"), tout[:4], jout[:4]):
        if name == "buf" or name == "w":
            assert rel(t2n(a), b) < TOL, name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert int((tout[1] == tcfg.n_experts * 8).sum()) > 0     # drops
    probs = np.full((6, 8), 0.125, np.float32)      # all ties
    probs[1, 5] = probs[3, 0] = 0.3
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = moe.top_k(torch.as_tensor(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with torch.no_grad():
        y, aux = moe.apply_moe(
            jax.tree.map(lambda a: a, {k: v[0] for k, v in
                                       tp["units"]["b0"]["ffn"].items()}),
            torch.as_tensor(xt).reshape(2, 24, -1), tcfg)
    jy, jaux = jmoe.apply_moe(
        {k: v[0] for k, v in jp["units"]["b0"]["ffn"].items()},
        jnp.asarray(xt).reshape(2, 24, -1), jcfg)
    assert rel(t2n(y), jy) < TOL and rel(float(aux), float(jaux)) < TOL


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


def test_one_chunk_decode_attention_runs_no_more_ops_than_flash():
    """Against a cache of one chunk, the decode's online softmax
    (``grouped_decode_attention``) runs no more ops than
    ``flash_attention(chunk_q=1)`` (a decode step is launch-bound), and
    both give the same rows; over four chunks it still does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import attention

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, fn, types, args=(), kwargs=None):
            self.n += 1
            return fn(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    q = torch.randn((4, 1, 4, 8), generator=g)
    k = torch.randn((4, 64, 2, 8), generator=g)
    v = torch.randn((4, 64, 2, 8), generator=g)
    q_pos = torch.tensor([[63], [40], [7], [0]])
    kv_pos = torch.arange(64).expand(4, 64)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=True)
    with Ops() as flash:
        y0 = attention.flash_attention(q, k, v, chunk_q=1, **kw)
    with Ops() as grouped:
        y1 = attention.grouped_decode_attention(q, k, v, chunk_kv=64, **kw)
    assert grouped.n <= flash.n, (grouped.n, flash.n)
    y2 = attention.grouped_decode_attention(q, k, v, chunk_kv=16, **kw)
    assert float((y1 - y0).abs().max()) < 1e-6
    assert float((y2 - y0).abs().max()) < 1e-6


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

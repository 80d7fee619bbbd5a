"""``repro_torch.serve`` against ``repro.serve`` — mirrors the nine tests of
``tests/test_serve.py`` on the port's engine (on the CPU), and holds the
port's engine to the JAX engine on the same parameters and prompts.

Parameters come from the JAX ``init_model(PRNGKey(0))`` of llama3_2_1b
SMOKE and are carried by ``convert.lm_params``.  Both engines serve the
same requests with the dense head and with the pruned sparse head at
densities 1.0 and 0.5 (``ehyb``); every prefill and decode step's logits
agree within 1e-4 of the largest, and the greedy tokens are equal.  Where
two logits of a row come within that tolerance of each other, a token
could flip on rounding alone, so tokens are compared only up to that step
(``_first_near_tie``); with these seeds no step has such a tie, which the
test also checks, so every token is compared.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_model as jinit_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.core import counters
from repro_torch.models import decode_step, init_decode_state, prefill
from repro_torch.models.layers import logits_fn
from repro_torch.serve import Request, ServeEngine

TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("llama3_2_1b", smoke=True)
    jp = jinit_model(jax.random.PRNGKey(0), jcfg)
    cfg = convert.model_config(jcfg)
    params = convert.lm_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jp, jcfg, params, cfg


def engine(setup, **kw):
    _, _, params, cfg = setup
    return ServeEngine(params, cfg, device="cpu", **kw)


def test_engine_matches_manual_greedy_loop(setup):
    _, _, params, cfg = setup
    prompt = np.arange(1, 9, dtype=np.int32)
    max_prompt, max_new = 16, 5

    eng = engine(setup, batch=1, max_len=64, max_prompt=max_prompt)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=max_new))
    got = eng.run_until_done()[0].generated

    # manual loop: pad the prompt to max_prompt like the engine does
    toks = np.zeros((1, max_prompt), np.int32)
    toks[0, : len(prompt)] = prompt
    with torch.no_grad():
        st = init_decode_state(cfg, 1, 64, torch.float32, device="cpu")
        h, st = prefill(params, {"tokens": toks}, cfg, st)
        logits = logits_fn(params["head"], params["embed"], h, cfg)
        want = [int(torch.argmax(logits[0, 0]))]
        pos = len(prompt)
        for _ in range(max_new - 1):
            h, st = decode_step(params, [[want[-1]]], cfg, st, pos)
            logits = logits_fn(params["head"], params["embed"], h, cfg)
            want.append(int(torch.argmax(logits[0, 0])))
            pos += 1
    assert got == want


def test_continuous_batching_slot_reuse(setup):
    cfg = setup[3]
    eng = engine(setup, batch=2, max_len=48, max_prompt=8)
    rng = np.random.default_rng(0)
    for i in range(5):                      # more requests than slots
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, 6, dtype=np.int32), max_new_tokens=4))
    done = eng.run_until_done()
    assert sorted(r.uid for r in done) == [0, 1, 2, 3, 4]
    assert all(len(r.generated) == 4 for r in done)


def test_eos_stops_generation(setup):
    probe = engine(setup, batch=1, max_len=48, max_prompt=8)
    probe.submit(Request(uid=1, prompt=np.arange(4, dtype=np.int32),
                         max_new_tokens=3))
    ref = probe.run_until_done()[0].generated
    eng = engine(setup, batch=1, max_len=48, max_prompt=8)
    eng.submit(Request(uid=2, prompt=np.arange(4, dtype=np.int32),
                       max_new_tokens=20, eos_id=ref[1]))
    done = eng.run_until_done()
    assert done[0].generated[-1] == ref[1]
    assert len(done[0].generated) <= 3


def test_sparse_head_decode_matches_dense_head_at_high_density(setup):
    """The pruned decode head at density 1.0 reproduces the dense head's
    greedy generations."""
    from repro_torch.autotune import available_formats

    prompt = np.arange(1, 9, dtype=np.int32)
    outs = {}
    for name, kw in (("dense", {}), ("sparse", {"sparse_head_density": 1.0})):
        eng = engine(setup, batch=1, max_len=64, max_prompt=16, **kw)
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
        outs[name] = eng.run_until_done()[0].generated
    assert outs["sparse"] == outs["dense"]
    assert eng.sparse_head is not None
    assert eng.sparse_head.op.format in available_formats()


def test_staggered_admission_matches_sequential_decoding(setup):
    """Slots admitted at different times decode at their own positions:
    staggered admission into a batch=2 engine reproduces what each request
    generates alone."""
    prompts = [np.arange(1, 7, dtype=np.int32),      # len 6
               np.arange(3, 7, dtype=np.int32)]      # len 4
    refs = []
    for uid, prompt in enumerate(prompts):
        solo = engine(setup, batch=1, max_len=48, max_prompt=8)
        solo.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
        refs.append(solo.run_until_done()[0].generated)

    eng = engine(setup, batch=2, max_len=48, max_prompt=8)
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=6))
    done = eng.step() + eng.step()       # slot 0 pulls ahead by two tokens
    eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=6))
    done += eng.run_until_done()
    got = {r.uid: r.generated for r in done}
    assert got[0] == refs[0]
    assert got[1] == refs[1]


def test_max_new_tokens_is_exact(setup):
    for max_new in (1, 2, 5):
        eng = engine(setup, batch=1, max_len=48, max_prompt=8)
        eng.submit(Request(uid=0, prompt=np.arange(1, 6, dtype=np.int32),
                           max_new_tokens=max_new))
        done = eng.run_until_done()
        assert len(done) == 1
        assert len(done[0].generated) == max_new


def test_eos_at_prefill_stops_before_decode(setup):
    prompt = np.arange(1, 6, dtype=np.int32)
    probe = engine(setup, batch=1, max_len=48, max_prompt=8)
    probe.submit(Request(uid=0, prompt=prompt, max_new_tokens=1))
    first = probe.run_until_done()[0].generated[0]
    eng = engine(setup, batch=1, max_len=48, max_prompt=8)
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=20,
                       eos_id=first))
    done = eng.run_until_done()
    assert done[0].generated == [first]


def test_sparse_head_batched_decode_matches_dense_head(setup):
    """Two concurrent requests through the batch-wide coalesced sparse head
    (density 1.0) generate exactly what the dense head does."""
    def reqs():
        return [Request(uid=i, prompt=np.arange(1 + i, 7 + i, dtype=np.int32),
                        max_new_tokens=4) for i in range(2)]

    outs = {}
    for name, kw in (("dense", {}), ("sparse", {"sparse_head_density": 1.0})):
        eng = engine(setup, batch=2, max_len=48, max_prompt=8, **kw)
        for r in reqs():
            eng.submit(r)
        outs[name] = {r.uid: r.generated for r in eng.run_until_done()}
    assert outs["sparse"] == outs["dense"]


def test_refresh_sparse_head_refills_without_rebuild(setup):
    """A weight push refreshes the served pruned head through the value
    scatter: same mask, same partitioning, no partition/build/pack pass —
    and the next step computes with the new values."""
    _, _, params, cfg = setup
    eng = engine(setup, batch=1, max_len=48, max_prompt=8,
                 sparse_head_density=0.5, sparse_head_format="ehyb")
    eng.submit(Request(uid=0, prompt=np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=3))
    eng.run_until_done()

    obj_before = eng.sparse_head.op.obj
    params2 = dict(params)
    key = "embed" if cfg.tie_embeddings else "head"
    name = "embedding" if cfg.tie_embeddings else "w_head"
    params2[key] = dict(params[key], **{name: params[key][name] * 2.0})
    before = counters.snapshot()
    head = eng.refresh_sparse_head(params2)
    after = counters.snapshot()
    for c in ("partition", "build_ehyb", "pack_staircase", "build_buckets",
              "group_er", "ehyb_refill"):
        assert after.get(c, 0) == before.get(c, 0), c
    assert head.op.obj.ell_cols is obj_before.ell_cols    # structure shared
    torch.testing.assert_close(head.op.obj.ell_vals,
                               2.0 * obj_before.ell_vals, rtol=1e-6,
                               atol=0)
    # the next step's logits follow the new values: twice the old ones
    seen = []
    real = eng._guarded_call

    def spy(which, *args):
        out = real(which, *args)
        seen.append(out[0])
        return out

    eng._guarded_call = spy
    eng.submit(Request(uid=1, prompt=np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=3))
    done = eng.run_until_done()
    assert len(done) == 1 and len(done[0].generated) == 3
    with torch.no_grad():
        h, _ = prefill(params2, {"tokens": np.pad(np.arange(1, 6), (0, 3))[
            None]}, cfg, init_decode_state(cfg, 1, 48, torch.float32,
                                           device="cpu"))
        want = head.apply_with(obj_before, h)[:, 0] * 2.0
    np.testing.assert_allclose(seen[0], want.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the port's engine against the JAX engine
# ---------------------------------------------------------------------------

def _record(eng, log: list) -> None:
    """Record every step's host logits (B, V) of ``eng``."""
    real = eng._guarded_call

    def spy(which, *args):
        out = real(which, *args)
        log.append((which, np.asarray(out[0], dtype=np.float64)))
        return out

    eng._guarded_call = spy


def _first_near_tie(logits: np.ndarray, tol: float) -> bool:
    """Some row's two largest logits within ``tol`` of the largest
    magnitude: a greedy token there may flip on rounding alone."""
    top2 = np.sort(logits, axis=1)[:, -2:]
    return bool((top2[:, 1] - top2[:, 0] <= tol * np.abs(logits).max())
                .any())


def _requests(cls):
    rng = np.random.default_rng(7)
    return [cls(uid=i, prompt=rng.integers(1, 512, int(rng.integers(3, 9)),
                                           dtype=np.int32),
                max_new_tokens=int(rng.integers(3, 7))) for i in range(5)]


@pytest.mark.parametrize("head", [{}, {"sparse_head_density": 1.0,
                                       "sparse_head_format": "ehyb"},
                                  {"sparse_head_density": 0.5,
                                   "sparse_head_format": "ehyb"}],
                         ids=["dense", "sparse_1.0", "sparse_0.5"])
def test_engine_matches_jax_engine(setup, head):
    jp, jcfg, params, cfg = setup
    kw = dict(batch=2, max_len=48, max_prompt=8, **head)
    jeng = JServeEngine(jp, jcfg, **kw)
    teng = ServeEngine(params, cfg, device="cpu", **kw)
    logs = ([], [])
    for eng, log, cls in ((jeng, logs[0], JRequest), (teng, logs[1],
                                                      Request)):
        _record(eng, log)
        for r in _requests(cls):
            eng.submit(r)
    jdone = {r.uid: r.generated for r in jeng.run_until_done()}
    tdone = {r.uid: r.generated for r in teng.run_until_done()}
    if head:
        assert teng.sparse_head.op.format == jeng.sparse_head.op.format
        np.testing.assert_array_equal(teng.sparse_head.csr.indices,
                                      jeng.sparse_head.csr.indices)
    tie = None
    for step, ((wj, lj), (wt, lt)) in enumerate(zip(*logs)):
        assert wj == wt, step
        assert lt.shape == lj.shape
        assert np.abs(lt - lj).max() <= TOL * np.abs(lj).max(), step
        if _first_near_tie(lj, TOL):
            tie = step
            break
    assert tie is None, f"a near tie at step {tie}: tokens compared to it"
    assert len(logs[0]) == len(logs[1])
    assert tdone == jdone


def test_launch_serve_cli_serves_twelve_requests(capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", "llama3_2_1b", "--smoke", "--device",
                       "cpu"])
    assert len(done) == 12 and all(len(r.generated) == 8 for r in done)
    assert "served 12 requests, 96 tokens" in capsys.readouterr().out


def test_engine_on_other_architectures(setup):
    """Every ported family serves: gemma2 (window, softcaps) and whisper
    (encoder-decoder, learned positions) through the same engine, with the
    JAX engine's greedy tokens."""
    for arch in ("gemma2_2b", "whisper_tiny"):
        jcfg = jget_config(arch, smoke=True)
        jp = jinit_model(jax.random.PRNGKey(0), jcfg)
        cfg = convert.model_config(jcfg)
        params = convert.lm_params(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
        outs = []
        for eng, cls in ((JServeEngine(jp, jcfg, batch=2, max_len=32,
                                       max_prompt=8), JRequest),
                         (ServeEngine(params, cfg, batch=2, max_len=32,
                                      max_prompt=8, device="cpu"),
                          Request)):
            for r in _requests(cls):
                eng.submit(r)
            outs.append({r.uid: r.generated for r in eng.run_until_done()})
        assert outs[0] == outs[1], arch


def test_engine_default_device_is_cuda(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, params, cfg = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, cfg, batch=1, max_len=16, max_prompt=4)

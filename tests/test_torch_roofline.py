"""The port's roofline (``repro_torch.roofline``) against fixed answers,
torch's own flop counter, real gloo ranks and the JAX package.

* the counter (``op_cost``): a loop of 16 matmuls counts 16·2·8·64·64
  flops (``tests/test_sharding.py::test_hlo_cost_parser_scan_
  multiplication``'s answer), one all-reduce of a 16 × 16 fp32 tensor on a
  fake group 1,024 bytes (``test_hlo_cost_parser_collectives``'s), and the
  peak of a hand-built run of allocations, views, in-place ops and frees
  is exact; a scaled count refuses real tensors; ``layers.remat_through``
  reaches every remat region of its own thread only; the replayed peak
  is the unrolled one with a shared aux gradient and a nested region;
* every architecture's smoke train step on a fake 2 × 2 mesh: the
  counter's flops equal ``FlopCounterMode``'s matmul entries, and the
  scaled count (each unit and loss chunk run once, then replayed; scan
  chunks inside a unit's run) equals the unrolled one in flops, bytes,
  collectives and peak;
* llama3_2_1b and moonshot on a real 2 × 2 gloo group: rank 0's
  collectives, call by call, are the fake group's;
* ``count_params``, ``model_flops_for``, ``roofline()`` and
  ``summarize.table`` equal the reference's; rank 0's train flops on a
  (4, 1) mesh, and on (2, 2) for llama3_2_1b, moonshot and rwkv6 (the
  model peers split the step), are within ``FLOPS_TOL`` of the
  reference's ``analyze_hlo`` of the compiled cell, its prefill and
  decode flops on (2, 2) (llama3_2_1b, moonshot, rwkv6 and jamba) within
  ``SERVE_FLOPS_TOL``, and so its prefill and decode flops on (1, 4)
  (llama3_2_1b and gemma2_2b: the kv projection split on columns, the
  cache on head_dim); the three ``act_sharding="sp"`` architectures'
  train flops on (2, 2) and prefill flops on (1, 4) within
  ``SP_FLOPS_TOL``, with the sequence's reduce-scatters in the port's
  collectives.

Fake and gloo runs are subprocesses of ``tests/torch_cost_worker.py`` (a
fake group is its process's default group); the reference's compiled
cells run in a subprocess with 4 host devices.

  python tests/test_torch_roofline.py --ratios

prints rank 0's flops against the reference's for every architecture on
(4, 1) and (2, 2): the train step, and the prefill and decode; and on
(1, 4) the prefill and decode of
llama3_2_1b and gemma2_2b, llama3_2_1b's decode against an 8,192-deep
cache, and the prefill of the three ``act_sharding="sp"``
architectures; beside each step's flops, both sides' collective bytes
by op (PERF.md's finding).
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORKER = Path(__file__).with_name("torch_cost_worker.py")
TIMEOUT = 300

sys.path.insert(0, str(SRC))

from repro_torch.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro_torch.roofline import analysis, op_cost, summarize  # noqa: E402

# rank 0's flops against the reference's analyze_hlo on (4, 1), measured
# (port / reference): 1.05 (jamba) to 1.18 (llama3_2_1b, yi, chameleon)
FLOPS_TOL = (1.0, 1.2)
REF_ARCHS = ("llama3_2_1b", "moonshot_v1_16b_a3b", "rwkv6_7b")
# the mesh prefill and decode on (2, 2): the model peers split the dense
# matmuls, as the reference's program does (without the split they would
# repeat them, as the train cells' 1.61-2.36x shows), Mamba and RWKV
# blocks too
SERVE_FLOPS_TOL = (0.8, FLOPS_TOL[1])
SERVE_ARCHS = ("llama3_2_1b", "moonshot_v1_16b_a3b", "rwkv6_7b",
               "jamba_1_5_large_398b")
SERVE_KINDS = ("prefill", "decode")
# on (1, 4) their 2 kv heads do not divide `model`: the cache splits on
# head_dim, and the decode sums partial scores over `model`; the kv
# projection splits on columns, k and v gathered
HEAD_DIM_ARCHS = ("llama3_2_1b", "gemma2_2b")
# the train step on (2, 2): the model peers split the dense matmuls, and
# rwkv6's time mix on heads and channel mix on d_ff (jamba's reference
# compile of the train cell takes longer: `--ratios` prints its ratio)
TP_ARCHS = REF_ARCHS
# sequence-parallel activations (act_sharding="sp"): the (2, 2) train
# step and the (1, 4) prefill, the port's rank 0 within 1 % of the
# reference's flops (measured 0.9951-1.0041 train, 1.0000 prefill).  The
# port's sequence reduce-scatters are reduce-scatters; the reference's
# CPU-compiled program lowers them as all-reduces and slices (its
# all-reduce bytes grow under SP, chameleon's (2, 2) train 7.76 -> 8.55
# MB), and both gather the sequence
SP_ARCHS = ("jamba_1_5_large_398b", "chameleon_34b", "grok_1_314b")
SP_FLOPS_TOL = (0.99, 1.01)

REFERENCE_FLOPS = """
import json, os, sys
import jax
jax.devices()                      # 4 host devices, before the dry run's
from repro.configs import get_config   # module sets its own device count
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.launch.dryrun import build_cell
from repro.roofline.hlo_cost import analyze_hlo

d, m = (int(x) for x in sys.argv[1].split(","))
out = {}
for kind in (sys.argv[3] if len(sys.argv) > 3 else "train").split(","):
    for arch in sys.argv[2].split(","):
        cfg = get_config(arch, smoke=True)
        rows = 4 * cfg.microbatches if kind == "train" else 4
        shape = ShapeConfig("t", int(sys.argv[4]) if len(sys.argv) > 4
                            else 32, rows, kind)
        jitted, specs = build_cell(cfg, shape, make_host_mesh(d, m))
        key = arch if kind == "train" else f"{kind}/{arch}"
        r = analyze_hlo(jitted.lower(*specs).compile().as_text())
        out[key] = {k: r[k] for k in ("flops", "coll_bytes", "coll_by_op")}
print(json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env.pop("XLA_FLAGS", None)
    return env


def start_worker(scenario, out: Path, rank=None, world=None, store=None):
    cmd = [sys.executable, str(WORKER), scenario, str(out)]
    if rank is not None:
        cmd += [str(rank), str(world), str(store)]
    return subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def start_reference(dims: str, archs, kinds=("train",), depth: int = 32):
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE_FLOPS), dims,
         ",".join(archs), ",".join(kinds), str(depth)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def join(procs, outs=()):
    """Wait for every process; the JSON each ``outs`` file holds (a
    reference process: its last stdout line)."""
    deadline = time.monotonic() + TIMEOUT
    got, errors = [], []
    try:
        for p in procs:
            stdout, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            if p.returncode:
                errors.append(err[-3000:])
            got.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, errors[0]
    return [json.loads(Path(o).read_text()) if o else
            json.loads(s.strip().splitlines()[-1])
            for o, s in zip(outs, got)]


# ---------------------------------------------------------------------------
# the counter against fixed answers
# ---------------------------------------------------------------------------

def test_counter_loop_of_matmuls_counts_each_one():
    w = torch.randn(16, 64, 64)
    x = torch.randn(8, 64)

    def loop(w, x):
        for i in range(16):
            x = torch.tanh(x @ w[i])
        return x

    r = op_cost.count(loop, w, x)
    assert r["flops"] == 16 * 2 * 8 * 64 * 64
    # each matmul reads its operands and writes its result, fp32
    assert r["dot_bytes"] == 16 * 4 * (8 * 64 + 64 * 64 + 8 * 64)
    assert r["coll_bytes"] == 0


def test_counter_peak_of_a_hand_built_run_is_exact():
    """Allocations add their storage, views and in-place ops add nothing,
    frees take their storage off; the peak counts the arguments."""
    a = torch.zeros(256)                              # 1,024 bytes, held

    def run(a):
        b = torch.ones(512)                           # +2,048
        v = b.view(16, 32)[3:5]                       # a view: +0
        v.add_(1.0)                                   # in place: +0
        b.mul_(a.sum())                               # +4, then −4
        c = torch.empty(1024, dtype=torch.float64)    # +8,192 → peak
        del b, v, c                                   # −10,240
        d = torch.zeros(64)                           # +256
        return d

    cost = op_cost.OpCost()
    assert cost.hold(a) == 1024
    with cost:
        d = run(a)
    r = cost.result()
    assert r["peak_bytes"] == 1024 + 2048 + 8192
    assert r["argument_bytes"] == 1024
    assert cost.live == 1024 + d.numel() * 4          # a and d
    assert r["n_ops"] == 5                            # no view, no empty


def test_scaled_count_refuses_real_tensors():
    """A replayed region's outputs hold no values, so a scaled count on
    real tensors raises: in ``cost_train_step`` before anything is built,
    when the arguments are held, and at a region's call."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import layers

    cfg = get_config("llama3_2_1b", smoke=True)
    with pytest.raises(ValueError, match="fake tensors only"):
        dryrun.cost_train_step(cfg, None, 4, 8, scaled=True, fake=False)
    with pytest.raises(ValueError, match="fake tensors only"):
        op_cost.OpCost(scaled=True).hold(torch.zeros(4))
    x = torch.zeros(4, requires_grad=True)
    with op_cost.OpCost(scaled=True), \
            pytest.raises(ValueError, match="fake tensors only"):
        layers.remat(torch.sin, x)


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "rwkv6_7b"])
def test_remat_through_reaches_every_region_of_its_thread(arch):
    """Every remat region (unit, scan chunk, loss chunk) goes through
    ``layers.remat``: ``remat_through`` sees each kind in its own thread
    and none in another thread that runs the same step meanwhile, and
    the loss and gradients are those of the plain checkpoint."""
    import threading

    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_config
    from repro_torch.models import init_model, layers
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train.train_step import make_loss_fn, value_and_grad

    cfg = get_config(arch, smoke=True)
    params = init_model(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1),
             "mask": torch.ones(2, 16)}
    loss_fn = make_loss_fn(cfg)
    seen = []

    def hook(fn, *args):
        seen.append((fn.__name__, threading.get_ident()))
        return checkpoint(fn, *args, use_reentrant=False)

    plain = value_and_grad(loss_fn, params, batch)
    other = []
    with layers.remat_through(hook):
        t = threading.Thread(target=lambda: other.append(
            value_and_grad(loss_fn, params, batch)))
        t.start()
        hooked = value_and_grad(loss_fn, params, batch)
        t.join()
    me = threading.get_ident()
    scan = "_ssm_chunk" if arch.startswith("jamba") else "_wkv_chunk"
    assert {name for name, _ in seen} == {"_apply_unit", scan,
                                         "_xent_chunk"}
    assert {tid for _, tid in seen} == {me}
    for got in (hooked, other[0]):
        assert torch.equal(got[0], plain[0])
        for a, b in zip(tree_leaves(got[2]), tree_leaves(plain[2])):
            assert torch.equal(a, b)


def _aux_unit(w, v, x, inner: bool):
    """A unit that returns its output and an aux scalar, as a MoE unit
    does; ``inner``: with a chunk loop of nested remat regions, and its
    largest temporaries in its backward."""
    from repro_torch.models.layers import remat

    h = torch.tanh(x @ w)
    if inner:
        for _ in range(4):
            h = remat(_inner_chunk, h, v)
        h = torch.cat([h] * 16, 1)[:, :64].contiguous() + h
    return h, (h * h).mean()


def _inner_chunk(h, v):
    return torch.tanh(h @ v) * 2


@pytest.mark.parametrize("case", ["shared_gradient", "nested_region"])
def test_scaled_peak_equals_unrolled_peak(case):
    """The replayed peak is the unrolled one where a region's backward
    differs from its first: ``aux = aux + a`` hands every unit the same
    aux gradient, which outlives each unit's backward (it must not be
    freed inside the measurement); and with a chunk loop of remat
    regions inside the unit, which run in the unit's measurement as
    torch's nested checkpoint runs them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.layers import remat

    inner = case == "nested_region"
    n = 1 if inner else 2

    def step(ws, vs, x):
        aux = torch.zeros(())
        for w, v in zip(ws, vs):
            x, a = remat(_aux_unit, w, v, x, inner)
            aux = aux + a
        (x.sum() + aux).backward()

    def cost(scaled):
        with FakeTensorMode():
            ws = [torch.randn(64, 64, requires_grad=True) for _ in range(n)]
            vs = [torch.randn(64, 64, requires_grad=True) for _ in range(n)]
            x = torch.randn(32, 64)
            c = op_cost.OpCost(scaled=scaled)
            c.hold(ws, vs, x)
            with c:
                step(ws, vs, x)
            return c.result()

    s, u = cost(True), cost(False)
    assert s["regions"] and not u["regions"]
    for k in ("peak_bytes", "flops", "bytes", "dot_bytes"):
        assert s[k] == u[k], k


def test_counter_all_reduce_counts_its_bytes(launched):
    (res,) = joined(launched, "collective")
    world, data = res["world"], res["data"]
    assert world["coll_bytes"] == 16 * 16 * 4
    assert world["coll_by_op"] == {"all-reduce": 16 * 16 * 4}
    assert world["coll_by_axis"] == {"data,model": 1024}
    assert data["coll_by_axis"] == {"data": 1024}
    # ranks 0 and 2: one 8-GPU node
    assert data["coll_by_link"] == {"nvlink": 1024}
    assert not res["jax_loaded"]


# ---------------------------------------------------------------------------
# every architecture on a fake 2 × 2 mesh
# ---------------------------------------------------------------------------

ARCH_GROUPS = (("jamba_1_5_large_398b",),
               ("rwkv6_7b",) + tuple(a for a in ARCH_IDS if a not in (
                   "jamba_1_5_large_398b", "rwkv6_7b"))[:4],
               tuple(a for a in ARCH_IDS if a not in (
                   "jamba_1_5_large_398b", "rwkv6_7b"))[4:])


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every subprocess of this file, started at once (each test joins
    its own): ``{name: (processes, outputs)}``."""
    tmp = tmp_path_factory.mktemp("roofline")
    runs = {}
    outs = [tmp / f"archs{i}.json" for i in range(len(ARCH_GROUPS))]
    runs["archs"] = ([start_worker("archs:" + ",".join(g), o)
                      for g, o in zip(ARCH_GROUPS, outs)], outs)
    store = tmp / "calls.store"
    runs["calls"] = ([start_worker("calls", tmp / "fake.json")]
                     + [start_worker("calls", tmp / "gloo.json", r, 4, store)
                        for r in range(4)],
                     [tmp / "fake.json", tmp / "gloo.json"])
    runs["collective"] = ([start_worker("collective", tmp / "c.json")],
                          [tmp / "c.json"])
    out = tmp / "flops41.json"
    runs["flops41"] = ([start_worker(f"flops:4,1:{','.join(REF_ARCHS)}",
                                     out), start_reference("4,1", REF_ARCHS)],
                       [out, None])
    out = tmp / "serve22.json"
    runs["serve22"] = (
        [start_worker(f"flops:2,2:{','.join(SERVE_ARCHS)}:"
                      f"{','.join(SERVE_KINDS)}", out),
         start_reference("2,2", SERVE_ARCHS, SERVE_KINDS)], [out, None])
    out = tmp / "serve14.json"
    runs["serve14"] = (
        [start_worker(f"flops:1,4:{','.join(HEAD_DIM_ARCHS)}:"
                      f"{','.join(SERVE_KINDS)}", out),
         start_reference("1,4", HEAD_DIM_ARCHS, SERVE_KINDS)], [out, None])
    out = tmp / "train22.json"
    runs["train22"] = ([start_worker(f"flops:2,2:{','.join(TP_ARCHS)}",
                                     out), start_reference("2,2", TP_ARCHS)],
                       [out, None])
    out = tmp / "sp_train22.json"
    runs["sp_train22"] = (
        [start_worker(f"flops:2,2:{','.join(SP_ARCHS)}", out),
         start_reference("2,2", SP_ARCHS)], [out, None])
    out = tmp / "sp_prefill14.json"
    runs["sp_prefill14"] = (
        [start_worker(f"flops:1,4:{','.join(SP_ARCHS)}:prefill:32", out),
         start_reference("1,4", SP_ARCHS, ("prefill",))], [out, None])
    yield runs
    for procs, _ in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def joined(launched, name):
    procs, outs = launched[name]
    if len(outs) == len(procs):
        return join(procs, outs)
    join(procs)                                   # gloo ranks: rank 0 writes
    return [json.loads(Path(o).read_text()) for o in outs]


@pytest.fixture(scope="module")
def archs(launched):
    res = {}
    for r in joined(launched, "archs"):
        assert not r.pop("jax_loaded")
        res.update(r)
    return res


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counter_flops_equal_flop_counter_mode(archs, arch):
    u = archs[arch]["unrolled"]
    assert u["flops"] > 0
    assert u["flops"] == u["flop_counter"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_scaled_count_equals_unrolled_count(archs, arch):
    """Each remat region (unit, loss chunk) run once and replayed gives
    the unrolled run's counts and peak, exactly; a scan chunk, inside a
    unit, runs in that unit's measurement and is not replayed."""
    u, s = archs[arch]["unrolled"], archs[arch]["scaled"]
    for k in ("flops", "bytes", "dot_bytes", "coll_bytes", "coll_by_op",
              "coll_by_axis", "coll_by_link", "peak_bytes", "held_bytes",
              "n_ops"):
        assert s[k] == u[k], (arch, k, s[k], u[k])
    assert s["regions"]["_gathered_unit"] >= 1
    assert sum(s["regions"].values()) > len(s["regions"])    # replays
    assert not {"_wkv_chunk", "_ssm_chunk"} & set(s["regions"])


# ---------------------------------------------------------------------------
# collectives: the fake group against real gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calls(launched):
    return joined(launched, "calls")


@pytest.mark.parametrize("arch", ["llama3_2_1b", "moonshot_v1_16b_a3b"])
def test_collective_bytes_fake_equal_gloo(calls, arch):
    fake, gloo = calls
    assert fake[arch]["coll_calls"] == gloo[arch]["coll_calls"]
    assert fake[arch]["coll_by_op"] == gloo[arch]["coll_by_op"]
    assert fake[arch]["flops"] == gloo[arch]["flops"]
    ops = {c[0] for c in gloo[arch]["coll_calls"]}
    if arch.startswith("moonshot"):
        # fsdp: the units' weights gathered over `data`
        assert {"all-gather", "all-reduce"} <= ops
        assert "all-to-all" in ops                    # the MoE's exchange
        assert any(c[1] == "data,model" for c in gloo[arch]["coll_calls"])
    else:
        # no fsdp, every `model` shard computed on where it lies (the kv
        # heads divide the axis): nothing gathered, only the split's and
        # the batch's sums
        assert ops == {"all-reduce"}
        assert {c[1] for c in gloo[arch]["coll_calls"]} == {"data", "model"}


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops_match_reference(arch):
    import jax

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.models import init_model as jinit_model
    from repro.roofline import analysis as ja
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    jcfg = jget_config(arch)
    jp = jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(0), jcfg))
    cfg = get_config(arch)
    tp = dryrun.abstract_params(cfg)
    assert analysis.count_params(tp) == ja.count_params(jp)
    assert analysis.count_params(tp, active_only=True, cfg=cfg) == \
        ja.count_params(jp, active_only=True, cfg=jcfg)
    assert dryrun.count_params is analysis.count_params
    for name in SHAPES:
        assert analysis.model_flops_for(cfg, SHAPES[name], tp) == \
            ja.model_flops_for(jcfg, JSHAPES[name], jp), name


def test_roofline_terms_match_reference(monkeypatch):
    from repro.roofline import analysis as ja

    monkeypatch.setattr(ja, "PEAK_FLOPS", analysis.PEAK_FLOPS)
    monkeypatch.setattr(ja, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(ja, "ICI_BW", analysis.NVLINK_BW)
    for flops, hbm, coll, chips, mf in (
            (7.5e14, 3.9e12, 1.7e11, 256, 1.2e17),
            (1e9, 5e12, 1e6, 512, 0.0),
            (1e6, 1e3, 9e12, 1, 1e6), (0.0, 0.0, 0.0, 4, 0.0)):
        got = analysis.roofline(flops, hbm, coll, chips=chips,
                                model_flops=mf)
        want = ja.roofline(flops, hbm, coll, chips=chips, model_flops=mf)
        assert got.as_dict() == want.as_dict()
    # priced by link: the network's part at 50 GB/s, NVLink's at 450
    t = analysis.roofline(0.0, 0.0, 1e9, chips=16,
                          coll_by_link={"nvlink": 4.5e8, "network": 5.5e8})
    assert t.collective_s == pytest.approx(4.5e8 / 450e9 + 5.5e8 / 50e9)
    assert analysis.link_of(range(8)) == "nvlink"
    assert analysis.link_of([0, 16]) == "network"


def _records():
    def train(arch, mesh, dominant, useful, top):
        return {"arch": arch, "shape": "train_4k", "mesh": mesh,
                "status": "OK",
                "roofline": {"compute_s": 0.76, "memory_s": 1.2,
                             "collective_s": 0.0004, "dominant": dominant,
                             "useful_ratio": useful},
                "memory": {"peak_estimate_bytes": 53_461_000_000,
                           "argument_bytes": 931_000_000},
                "collectives_top": top}

    top = [{"op": "all-gather bfloat16[512, 2048] over model",
            "bytes": 4_000_000_000}]
    return [
        train("llama3_2_1b", "single_pod_16x16", "memory", 0.04, top),
        train("moonshot_v1_16b_a3b", "single_pod_16x16", "collective",
              0.1, top),
        train("yi_6b", "single_pod_16x16", "compute", 0.04, []),
        train("gemma2_2b", "single_pod_16x16", "compute", 0.8, []),
        {"arch": "llama3_2_1b", "shape": "long_500k",
         "mesh": "single_pod_16x16", "status": "SKIP",
         "reason": "full-attention arch: long_500k requires sub-quadratic "
                   "mixer"},
        {"arch": "grok_1_314b", "shape": "train_4k",
         "mesh": "multi_pod_2x16x16", "status": "FAIL", "error": "x"},
    ]


def test_summarize_table_matches_reference(tmp_path):
    from repro.roofline import summarize as js

    recs = _records()
    for mesh in summarize.MESHES:
        assert summarize.table(recs, mesh) == js.table(recs, mesh)
    for r in recs[:4]:
        assert summarize.bottleneck_note(r) == js.bottleneck_note(r)
    # a cell without a cost prints its reason in place of the terms
    serve = {"arch": "llama3_2_1b", "shape": "decode_32k",
             "mesh": "single_pod_16x16", "status": "OK",
             "memory": {"argument_bytes": 2**30},
             "cost": None, "cost_reason": "no cost: head-sharded cache"}
    row = summarize.table([serve], "single_pod_16x16").splitlines()[-1]
    assert row == ("| llama3_2_1b | decode_32k | OK | — | — | — | — "
                   "| 1.0 (args) | — | no cost: head-sharded cache |")
    # load_records reads <dir>/<mesh>/<cell>.json
    for r in recs:
        d = tmp_path / r["mesh"]
        d.mkdir(exist_ok=True)
        (d / f"{r['arch']}__{r['shape']}.json").write_text(json.dumps(r))
    assert sorted(summarize.load_records(str(tmp_path)),
                  key=json.dumps) == sorted(recs, key=json.dumps)


def flops_against_reference(dims: str, arch_ids, tmp: Path,
                            kinds=("train",), depth: int = 32) -> dict:
    """``{key: (port's rank-0 result, reference's)}`` on a (D, M) mesh
    (flops; a serving step's also ``coll_bytes`` and ``coll_by_op``); a
    key is the architecture for a train step, ``kind/arch`` for a prefill
    or decode step (``depth``: its tokens, or its cache's depth)."""
    out = tmp / f"port_{dims.replace(',', 'x')}_{'_'.join(kinds)}.json"
    tail = "" if tuple(kinds) == ("train",) else \
        f":{','.join(kinds)}:{depth}"
    port, ref = join([start_worker(f"flops:{dims}:{','.join(arch_ids)}"
                                   + tail, out),
                      start_reference(dims, arch_ids, kinds, depth)],
                     [out, None])
    return {k: (port[k], ref[k]) for k in ref}


def test_data_mesh_flops_within_tolerance_of_reference(launched):
    ports, refs = joined(launched, "flops41")
    for arch in REF_ARCHS:
        port, ref = ports[arch]["flops"], refs[arch]["flops"]
        assert FLOPS_TOL[0] <= port / ref <= FLOPS_TOL[1], (arch, port, ref)


@pytest.mark.parametrize("kind", SERVE_KINDS)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_flops_on_two_by_two_within_tolerance_of_reference(
        launched, arch, kind):
    """Rank 0's flops of the mesh prefill (4 × 32 tokens) and decode (4
    rows against a 32-deep cache) on (data, model) = (2, 2), against the
    reference's ``analyze_hlo`` of ``build_cell``'s compiled step."""
    ports, refs = joined(launched, "serve22")
    port = ports[f"{kind}/{arch}"]["flops"]
    ref = refs[f"{kind}/{arch}"]["flops"]
    assert SERVE_FLOPS_TOL[0] <= port / ref <= SERVE_FLOPS_TOL[1], \
        (arch, kind, port, ref)


@pytest.mark.parametrize("arch", HEAD_DIM_ARCHS)
def test_head_dim_decode_flops_on_one_by_four_within_tolerance_of_reference(
        launched, arch):
    """Rank 0's flops of the mesh decode on (data, model) = (1, 4), where
    the cache splits on head_dim, against the reference's ``analyze_hlo``.
    The collectives differ by design (ROADMAP Queue 3): the port sums each
    cache chunk's partial scores over `model`, where the reference's
    compiled program gathers the cache's head_dim blocks; both are
    there."""
    ports, refs = joined(launched, "serve14")
    port, ref = ports[f"decode/{arch}"], refs[f"decode/{arch}"]
    assert SERVE_FLOPS_TOL[0] <= port["flops"] / ref["flops"] <= \
        SERVE_FLOPS_TOL[1], (arch, port, ref)
    assert port["coll_by_op"]["all-reduce"] > 0, port
    assert ref["coll_by_op"]["all-gather"] > 0, ref


@pytest.mark.parametrize("arch", HEAD_DIM_ARCHS)
def test_kv_split_prefill_flops_on_one_by_four_within_tolerance_of_reference(
        launched, arch):
    """Rank 0's flops of the mesh prefill (4 × 32 tokens) on (1, 4), where
    the 2 kv heads do not divide `model`: each rank projects its block of
    ``w_k``/``w_v``'s columns and gathers k and v, as the reference's
    program splits that projection (a repeated kv projection read
    1.2857×)."""
    ports, refs = joined(launched, "serve14")
    port, ref = ports[f"prefill/{arch}"], refs[f"prefill/{arch}"]
    assert SERVE_FLOPS_TOL[0] <= port["flops"] / ref["flops"] <= \
        SERVE_FLOPS_TOL[1], (arch, port, ref)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_train_flops_on_two_by_two_within_tolerance_of_reference(
        launched, arch):
    """Rank 0's train flops on (data, model) = (2, 2) against the
    reference's ``analyze_hlo``: the model peers split the dense matmuls,
    the head and the loss (a repeated step read 1.61–2.36×)."""
    ports, refs = joined(launched, "train22")
    port, ref = ports[arch]["flops"], refs[arch]["flops"]
    assert FLOPS_TOL[0] <= port / ref <= FLOPS_TOL[1], (arch, port, ref)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", SP_ARCHS)
def test_sequence_parallel_flops_and_collectives_against_reference(
        launched, arch, kind):
    """The three ``act_sharding="sp"`` architectures: rank 0's train flops
    on (data, model) = (2, 2) and prefill flops (4 × 32 tokens) on (1, 4)
    within ``SP_FLOPS_TOL`` of the reference's ``analyze_hlo``; the
    port's collectives hold the sequence's reduce-scatters and
    all-gathers, the reference's its all-gathers (its reduce-scatters
    compile to all-reduces on the CPU)."""
    name, key = (("sp_train22", arch) if kind == "train"
                 else ("sp_prefill14", f"prefill/{arch}"))
    ports, refs = joined(launched, name)
    port, ref = ports[key], refs[key]
    assert SP_FLOPS_TOL[0] <= port["flops"] / ref["flops"] <= \
        SP_FLOPS_TOL[1], (arch, kind, port["flops"], ref["flops"])
    assert port["coll_by_op"].get("reduce-scatter", 0) > 0, port
    assert port["coll_by_op"].get("all-gather", 0) > 0, port
    assert ref["coll_by_op"].get("all-gather", 0) > 0, ref


if __name__ == "__main__" and "--ratios" in sys.argv:
    import tempfile

    runs = [(dims, kinds, ARCH_IDS, 32)
            for dims in ("4,1", "2,2") for kinds in (("train",), SERVE_KINDS)]
    # the head_dim layout, and its decode against a deeper cache (where
    # each layer's cache is read in 2,048-row chunks)
    runs += [("1,4", SERVE_KINDS, HEAD_DIM_ARCHS, 32),
             ("1,4", ("decode",), HEAD_DIM_ARCHS[:1], 8192),
             ("1,4", ("prefill",), SP_ARCHS, 32)]
    with tempfile.TemporaryDirectory() as tmp:
        for dims, kinds, ids, depth in runs:
            got = flops_against_reference(dims, ids, Path(tmp), kinds, depth)
            for key, (port, ref) in got.items():
                line = (f"({dims}, depth {depth}) {key}: port "
                        f"{port['flops']:.6g} "
                        f"reference {ref['flops']:.6g} ratio "
                        f"{port['flops'] / ref['flops']:.4f}")
                if "coll_bytes" in port:
                    line += (f"; collectives port {port['coll_by_op']} "
                             f"reference {ref['coll_by_op']}")
                print(line)

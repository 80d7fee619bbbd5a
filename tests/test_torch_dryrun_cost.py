"""The dry run's cost half (``repro_torch.launch.dryrun``) and the two
faults that blocked it.

* the MoE's expert counts: a fixed-length scatter equal to ``bincount``
  and to the reference's ``jnp.bincount(length=e)``, static in shape
  under ``FakeTensorMode``;
* ``shard_ctx.axis_group``: a multi-axis group made under
  ``FakeTensorMode`` on a fake 2 × 2 group, and the same ranks on gloo as
  the tensor-built rank table gave (2 × 2 × 2, every pair of axes);
* ``rank_microbatches``: a rank with fewer rows than microbatches runs
  one row each, and on 2 gloo ranks that step equals the unsharded one;
* a production ``train_4k`` cell at full width (depth cut) replayed
  and unrolled: equal to the byte;
* a production ``train_4k`` cell's record (the reference's keys, the
  roofline terms, the peak's parts), an args-only record recomputed when
  a cost is asked for, a failed cost run recorded FAIL with exit 1, and
  ``roofline.summarize``'s tables;
* production serving cells costed (llama3_2_1b ``decode_32k`` on
  16 × 16: flops, collectives, peak, the cache held once, the state
  donated; rwkv6_7b ``decode_32k`` on 2 × 16 × 16, which once waited);
* ``fits`` with the headroom measured on the card, and ``margin_bytes``.

Fake and gloo runs are subprocesses of ``tests/torch_cost_worker.py``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORKER = Path(__file__).with_name("torch_cost_worker.py")
TIMEOUT = 300

sys.path.insert(0, str(SRC))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.roofline import summarize  # noqa: E402
from repro_torch.train.train_step import rank_microbatches  # noqa: E402


def run(scenario, tmp: Path, world=None) -> dict:
    """The worker's JSON: rank 0 of a fake group, or ``world`` gloo
    ranks."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = tmp / f"{scenario}.json"
    ranks = [None] if world is None else range(world)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), scenario, str(out)]
        + ([] if r is None else [str(r), str(world), str(tmp / "store")]),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in ranks]
    deadline = time.monotonic() + TIMEOUT
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            if p.returncode:
                errors.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, errors[0]
    res = json.loads(out.read_text())
    assert not res.pop("jax_loaded")
    return res


# ---------------------------------------------------------------------------
# the two faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,e", [(1, 4), (37, 8), (256, 64), (96, 16)])
def test_expert_counts_equal_bincount_and_reference(t, e):
    import jax.numpy as jnp

    idx = torch.as_tensor(np.random.default_rng(t).integers(0, e, t))
    idx[: t // 3] = 0                         # an expert with many, some
    got = moe.expert_counts(idx, e)           # with none
    assert got.dtype == torch.int64 and got.shape == (e,)
    assert torch.equal(got, torch.bincount(idx, minlength=e))
    ref = np.asarray(jnp.bincount(jnp.asarray(idx.numpy()), length=e))
    assert got.tolist() == ref.tolist()


def test_expert_counts_are_static_under_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        idx = torch.zeros(300, dtype=torch.int64)
        got = moe.expert_counts(idx, 16)
        assert tuple(got.shape) == (16,)
        with pytest.raises(Exception):           # what the fault was
            torch.bincount(idx, minlength=16)


def test_axis_group_is_made_under_fake_mode(tmp_path):
    assert run("group_fake", tmp_path)["ranks"] == [0, 1, 2, 3]


def test_axis_group_ranks_unchanged_on_gloo(tmp_path):
    res = run("group_gloo", tmp_path, world=8)
    assert set(res) == {"data,model", "pod,data", "pod,model"}
    for axes, got in res.items():
        assert got["group"] == got["tensor_row"], axes
    assert res["pod,data"]["group"] == [0, 2, 4, 6]


# ---------------------------------------------------------------------------
# a rank with fewer rows than microbatches
# ---------------------------------------------------------------------------

def test_rank_microbatches():
    assert rank_microbatches(16, 16) == 16
    assert rank_microbatches(8, 16) == 8        # jamba on 2 × 16 × 16
    assert rank_microbatches(1, 4) == 1
    assert rank_microbatches(12, 4) == 4
    with pytest.raises(ValueError, match="do not split"):
        rank_microbatches(6, 4)


def test_capped_microbatches_step_equals_unsharded(tmp_path):
    res = run("cap", tmp_path, world=2)
    mesh_loss, plain_loss = res["loss"]
    assert abs(mesh_loss - plain_loss) <= 1e-6 * abs(plain_loss)
    assert res["weights"] <= 1e-2 * 1e-3         # 1 % of lr, as the mesh
                                                 # tests hold the step


# ---------------------------------------------------------------------------
# the dry run's records
# ---------------------------------------------------------------------------

@pytest.fixture
def out_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path / "dryrun"))
    return tmp_path / "dryrun"


def test_train_cell_record_has_the_cost(out_dir, monkeypatch):
    """llama3_2_1b train_4k on 16 × 16: args only first, then the cost
    is asked for and the record recomputed (one fake run of 256 ranks in
    a subprocess); a third read comes from the record."""
    rec = dryrun.run_cell("llama3_2_1b", "train_4k", False, verbose=False,
                          cost=False, device_bytes=80 * 2**30)
    assert rec["cost"] is None and "flops_per_device" not in rec
    args = rec["memory"]["argument_bytes"]
    rec = dryrun.run_cell("llama3_2_1b", "train_4k", False, verbose=False,
                          device_bytes=80 * 2**30)
    for k in ("flops_per_device", "bytes_per_device",
              "bytes_per_device_upper", "collectives", "collectives_top",
              "n_params", "n_params_active", "roofline", "cost_s"):
        assert k in rec, k
    assert rec["status"] == "OK" and rec["chips"] == 256 and rec["regions"]
    mem = rec["memory"]
    assert mem["argument_bytes"] == args
    assert mem["peak_estimate_bytes"] == (mem["held_bytes"]
                                          + mem["output_bytes"]
                                          + mem["temp_bytes"]
                                          - mem["alias_bytes"])
    assert mem["peak_estimate_bytes"] > mem["held_bytes"] >= args
    assert rec["margin_bytes"] == (80 * 2**30 - dryrun.HEADROOM_BYTES
                                   - mem["peak_estimate_bytes"])
    assert rec["fits"] == (rec["margin_bytes"] >= 0)
    assert rec["bytes_per_device_upper"] > rec["bytes_per_device"] > 0
    assert set(rec["collectives"]) == {"all-gather", "all-reduce"}
    assert sum(rec["collectives_by_link"].values()) == \
        sum(rec["collectives"].values())
    t = rec["roofline"]
    assert t["dominant"] in ("compute", "memory", "collective")
    assert t["flops"] == rec["flops_per_device"]
    cfg = get_config("llama3_2_1b")
    assert t["model_flops"] == 6 * rec["n_params_active"] * 256 * 4096
    assert t["useful_ratio"] == pytest.approx(
        t["model_flops"] / (rec["flops_per_device"] * 256))
    # every unit of every microbatch replayed from one measurement
    assert rec["regions"]["_gathered_unit"] == cfg.n_layers * \
        cfg.microbatches

    def no_run(*a, **k):
        raise AssertionError("a recorded cost is read, not rerun")

    monkeypatch.setattr(dryrun, "cost_in_subprocess", no_run)
    again = dryrun.run_cell("llama3_2_1b", "train_4k", False, verbose=False)
    assert again["flops_per_device"] == rec["flops_per_device"]


def test_full_width_cell_replay_equals_unrolled(tmp_path):
    """moonshot's ``train_4k`` cell on 16 × 16 at full width, depth cut to
    2 layers (rank 0 of a fake group of 256 ranks): the replayed counts
    and peak are the unrolled run's, to the byte (the replay once freed
    the aux loss's shared gradient inside a unit's measured backward, and
    read this cell's peak 4 bytes low)."""
    res = run("cell:moonshot_v1_16b_a3b:single:2", tmp_path)
    s, u = res["scaled"], res["unrolled"]
    assert res["n_layers"] == 2
    for k in ("flops", "bytes", "dot_bytes", "coll_bytes", "coll_by_op",
              "peak_bytes"):
        assert s[k] == u[k], k


def test_serving_cell_record_has_the_cost(out_dir):
    """llama3_2_1b ``decode_32k`` on 16 × 16 (rank 0 of a fake group of
    256 ranks in a subprocess): the mesh decode step's flops, collectives
    (the head_dim-parallel scores' all-reduce over `model` on top), peak
    and fit.  The state is donated: the cache is held once — the step's
    peak above what it holds is below one unit's cache — and the new
    state's storages are the arguments'."""
    cfg = get_config("llama3_2_1b")
    rec = dryrun.run_cell("llama3_2_1b", "decode_32k", False, verbose=False,
                          device_bytes=80 * 2**30)
    assert rec["status"] == "OK" and rec["chips"] == 256
    for k in ("flops_per_device", "collectives", "collectives_by_axis",
              "roofline", "cost_s", "fits", "margin_bytes"):
        assert rec[k] is not None, k
    assert rec["flops_per_device"] > 0
    assert set(rec["collectives"]) == {"all-gather", "all-reduce"}
    assert rec["collectives_top"][0]["op"].startswith(
        "all-reduce float32") and "over model" in \
        rec["collectives_top"][0]["op"]
    mem = rec["memory"]
    state = mem["argument_bytes_by_arg"]["state"]
    assert mem["held_bytes"] == mem["argument_bytes"]
    assert mem["peak_estimate_bytes"] - mem["held_bytes"] < \
        state // cfg.n_units
    assert mem["alias_bytes"] == state
    assert rec["regions"]["_unit_in_place"] == cfg.n_units
    assert rec["fits"] and rec["margin_bytes"] == (
        80 * 2**30 - dryrun.HEADROOM_BYTES - mem["peak_estimate_bytes"])
    t = rec["roofline"]
    assert t["model_flops"] == 2 * rec["n_params_active"] * 128


def test_serving_cell_waits_with_a_reason(out_dir):
    """No serving cell waits any more: rwkv6_7b's ``decode_32k`` on
    2 × 16 × 16 (rank 0 of a fake group of 512 ranks in a subprocess) is
    costed like the attention cells — its time mix split on heads (4 of
    64 a rank), its WKV state held once and donated, no reason given."""
    cfg = get_config("rwkv6_7b")
    rec = dryrun.run_cell("rwkv6_7b", "decode_32k", True, verbose=False,
                          device_bytes=80 * 2**30)
    assert rec["status"] == "OK" and rec["chips"] == 512
    assert "cost" not in rec and "cost_reason" not in rec
    for k in ("flops_per_device", "fits", "margin_bytes", "roofline",
              "cost_s"):
        assert rec[k] is not None, k
    assert rec["flops_per_device"] > 0 and rec["fits"] is True
    mem = rec["memory"]
    assert rec["margin_bytes"] == (80 * 2**30 - dryrun.HEADROOM_BYTES
                                   - mem["peak_estimate_bytes"])
    assert mem["alias_bytes"] == mem["argument_bytes_by_arg"]["state"]
    assert rec["regions"]["_unit_in_place"] == cfg.n_units
    # the split's sums over `model` (w_o's rows, the channel mix's gathers)
    assert rec["collectives_by_axis"]["model"] > 0


def test_fits_keeps_the_measured_headroom():
    """jamba ``train_4k`` on 16 × 16 peaks at 85,011,501,360 bytes against
    the card's 85,017,493,504: 6 MB to spare no longer reads as a fit once
    the headroom is kept; a peak that leaves exactly the headroom fits."""
    card = 85_017_493_504
    assert dryrun.HEADROOM_BYTES > card - 85_011_501_360
    rec = {"status": "OK", "flops_per_device": 1.0,
           "memory": {"peak_estimate_bytes": 85_011_501_360}}
    dryrun._fit(rec, card)
    assert rec["fits"] is False and rec["margin_bytes"] < 0
    assert rec["headroom_bytes"] == dryrun.HEADROOM_BYTES
    rec["memory"]["peak_estimate_bytes"] = card - dryrun.HEADROOM_BYTES
    dryrun._fit(rec, card)
    assert rec["fits"] is True and rec["margin_bytes"] == 0
    args_only = {"status": "OK", "memory": {"argument_bytes": 10}}
    dryrun._fit(args_only, card)
    assert args_only["margin_bytes"] == card - dryrun.HEADROOM_BYTES - 10
    dryrun._fit(args_only, None)
    assert args_only["fits"] is None and args_only["margin_bytes"] is None


def test_failed_cost_run_is_a_fail(out_dir, monkeypatch, capsys):
    def broken(arch, shape, multi, **kw):
        raise RuntimeError("the fake run raised")

    monkeypatch.setattr(dryrun, "cost_in_subprocess", broken)
    rc = dryrun.main(["--arch", "llama3_2_1b", "--shape", "train_4k",
                      "--mesh", "single"])
    assert rc == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("dry-run complete: 0 OK, 0 SKIP, 1 FAIL")
    rec = json.loads((out_dir / "single_pod_16x16"
                      / "llama3_2_1b__train_4k.json").read_text())
    assert rec["status"] == "FAIL" and "fake run raised" in rec["error"]


def test_summarize_prints_both_meshes(out_dir, capsys):
    for multi in (False, True):
        for shape in ("train_4k", "decode_32k", "long_500k"):
            dryrun.run_cell("yi_6b", shape, multi, verbose=False,
                            cost=False)
    assert summarize.main([str(out_dir)]) == 0
    out = capsys.readouterr().out
    assert "## single_pod_16x16 (2 OK)" in out
    assert "## multi_pod_2x16x16 (2 OK)" in out
    assert out.count("| yi_6b | long_500k | SKIP |") == 2
    assert "args only: the cost was not asked for" in out

"""Multi-pod dry run: per-device memory, flops, bytes and collective bytes
of every cell, without a card.

The port of ``repro.launch.dryrun``.  For every (architecture × input
shape × production mesh) cell it records two halves.

**The arguments** (every cell).  The step's arguments as fake tensors
(``FakeTensorMode``: shapes and dtypes, nothing allocated, no process
group) as the reference's ``build_cell`` builds them —

* train: the fp32 params, the AdamW moments in ``cfg.opt_state_dtype``,
  the two step counters, and the batch of ``data.make_batch_specs``;
* prefill / decode: bf16 weights for the ≥ 2-D fp32 leaves (the other
  leaves keep their dtype), the decode state of ``init_decode_state``
  (context-parallel for ``long_500k``), and the tokens (plus the encoder
  frames of an encoder-decoder's prefill, and decode's position) —

placed under ``launch.sharding``'s specs on the production mesh's shape
(``launch.mesh.ShapeMesh``: 16 × 16 or 2 × 16 × 16): one device's bytes
(``memory.argument_bytes``, by argument in ``argument_bytes_by_arg``) and
``n_params``.

**The cost** (train cells).  Rank 0 of a ``fake`` process group of 256 or
512 ranks (no communication: each collective returns at once) runs the
port's own mesh step — ``make_train_step(cfg, OptimizerConfig(),
microbatches=cfg.microbatches, mesh=, donate=True)`` on the production
``DeviceMesh`` (``make_production_mesh(device_type="cpu")``), its state
built and distributed as ``launch.train.build_trainer`` builds it, on the
global batch — under ``FakeTensorMode`` and ``roofline.op_cost.OpCost``
(its layers split over `model` as the reference's GSPMD program does:
attention, MLP, MoE, Mamba, RWKV and the vocab).
That is the SPMD program each card runs, so its counts are one device's:
``flops_per_device``, ``bytes_per_device`` (matmul bytes, the memory
term's input), ``bytes_per_device_upper`` (every op's), ``collectives``
(by op; ``collectives_by_axis``, ``collectives_by_link``),
``collectives_top``, ``memory.peak_estimate_bytes`` (the live storages'
high-water mark, the arguments included) with its ``argument`` / ``held``
/ ``output`` / ``alias`` / ``temp`` parts, ``n_params_active``, the H100
``roofline`` terms and ``cost_s`` (the fake run's seconds).  Each unit
and loss chunk runs once per signature and is replayed at every later
call, a scan chunk inside a unit running in the unit's measurement
(``op_cost``'s repeats: its counts and its peak are the unrolled run's).  Each cell runs in a
subprocess of its own: the fake group is the process's default group.

**The cost** (serving cells).  The same fake rank runs
:func:`cost_serve_step`, the reference's ``build_cell`` serving branch on
the port's mesh prefill and decode (``models.transformer.prefill(...,
mesh=)`` / ``decode_step(..., mesh=)``, then ``serve_logits``: the logits
kept vocab-sharded): bf16 weights for the ≥ 2-D fp32 leaves, the decode
state of ``init_decode_state`` under ``state_specs`` (context-parallel
for ``long_500k``: the caches' sequence over `data`), the tokens under
``batch_specs``, the triangular block enumeration for prefill, and the
state donated (written in place: its storages are the output's).  Each
unit is measured once per signature and replayed.

``fits`` compares the peak plus ``HEADROOM_BYTES`` (what a process holds
on the card beyond its live tensors) with ``--device-bytes`` (default:
the card's ``total_memory`` when there is a card) where there is a peak,
else the argument bytes; ``margin_bytes`` is what is left.  Full-attention architectures skip ``long_500k``, as
in the reference.  Records go to ``build/dryrun/<mesh>/<arch>__<shape>
.json``; a re-run reads a recorded cell unless ``--force``, or unless the
record has no cost and a cost is asked for (a record read back is
rewritten with its fit on the device asked about).  A cell whose fake run
raises is recorded FAIL (the CLI then exits 1).

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] \\
      [--shape S] [--mesh single|multi|both] [--force] [--args-only] \\
      [--jobs N] [--device-bytes N]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from ..configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from ..data.pipeline import make_batch_specs
from ..models.transformer import init_decode_state, init_model, tree_leaves
from ..roofline.analysis import count_params, model_flops_for, roofline
from .mesh import PRODUCTION_SHAPES, ShapeMesh
from .sharding import (_map_with_path, batch_specs, local_size_bytes,
                       param_specs, state_specs)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")
MESHES = {False: "single_pod_16x16", True: "multi_pod_2x16x16"}
# what a process holds on the card beyond its live tensors, as phase 11i
# of chip_smoke.py measured it on an NVIDIA H100 80GB HBM3 at 700 W: the
# CUDA context (and NCCL's and the libraries' buffers outside the caching
# allocator), 1,378,746,368 bytes, plus the allocator's reserve over the
# allocated bytes at the peak of the card cell's train step (llama3_2_1b,
# 4 × 512 tokens, a one-rank mesh), 14,313,505,280 bytes
HEADROOM_BYTES = 15_692_251_648


def _fake(fn):
    """``fn()``'s tensors as fake ones: shapes and dtypes, no memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return fn()


def abstract_params(cfg) -> dict:
    return _fake(lambda: init_model(torch.Generator("cpu").manual_seed(0),
                                    cfg, device="cpu"))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cell_args(cfg, shape, mesh, serve_dtype=torch.bfloat16) -> dict:
    """``{argument: (tree of fake/meta tensors, tree of specs)}`` of the
    cell's step, as the reference's ``build_cell`` passes them."""
    params = abstract_params(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt_dt = getattr(torch, cfg.opt_state_dtype)
        moments = _map_with_path(lambda _, t: _meta(t.shape, opt_dt), params)
        p_spec = param_specs(params, mesh, cfg)
        batch = {k: _meta(*v) for k, v in make_batch_specs(cfg, shape).items()}
        steps = {"opt_step": _meta((), torch.int32),
                 "step": _meta((), torch.int32)}
        return {"params": (params, p_spec), "opt_m": (moments, p_spec),
                "opt_v": (moments, p_spec),
                "steps": (steps, {k: () for k in steps}),
                "batch": (batch, batch_specs(batch, mesh, global_batch=b,
                                             cfg=cfg))}
    params = _map_with_path(lambda _, t: _meta(
        t.shape, serve_dtype if t.dtype == torch.float32 and t.ndim >= 2
        else t.dtype), params)
    enc_len = s if cfg.family == "encdec" else 0
    state = _fake(lambda: init_decode_state(cfg, b, s, serve_dtype,
                                            enc_len=enc_len, device="cpu"))
    out = {"params": (params, param_specs(params, mesh, cfg)),
           "state": (state, state_specs(
               state, mesh, cfg, global_batch=b,
               context_parallel=shape.name == "long_500k"))}
    if shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32)}
        if cfg.family == "encdec":
            batch["enc_frames"] = _meta((b, s, cfg.d_model), serve_dtype)
    else:
        batch = {"tokens": _meta((b, 1), torch.int32)}
    out["batch"] = (batch, batch_specs(batch, mesh, global_batch=b, cfg=cfg))
    if shape.kind == "decode":
        out["pos"] = ({"pos": _meta((), torch.int32)}, {"pos": ()})
    return out


def device_bytes_of(tree, specs, mesh) -> int:
    """One device's bytes of ``tree``'s leaves under ``specs``."""
    leaves = list(tree_leaves(tree))
    spec_leaves = []
    _map_with_path(lambda _, s: spec_leaves.append(s), specs)
    return sum(local_size_bytes(tuple(t.shape), s, mesh, t.element_size())
               for t, s in zip(leaves, spec_leaves))


def card_bytes():
    """The card's memory, or None without one."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


# ---------------------------------------------------------------------------
# the cost half: one rank of a fake group
# ---------------------------------------------------------------------------

def fake_group(world_size: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of
    ``world_size`` ranks (its collectives return at once, untouched)."""
    import torch.distributed as dist
    # registers the "fake" backend (torch's own fake process group)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def cost_train_step(cfg, mesh, global_batch: int, seq_len: int, *,
                    microbatches=None, scaled=None, seed: int = 0,
                    opt_cfg=None, fake: bool = True) -> dict:
    """``op_cost``'s count of one train step of ``cfg`` on ``mesh`` (this
    rank's ``DeviceMesh``), under ``FakeTensorMode`` (``fake=False``: on
    real tensors on the mesh's device, the step really run): the state
    built and distributed as ``build_trainer`` does it, the step
    ``make_train_step(..., mesh=mesh, donate=True)`` on a global batch of
    ``make_batch_specs`` (tokens and labels 0, mask 1).  ``scaled``
    (default: ``fake``) replays the remat regions, which a fake run only
    may do: a real run raises ``ValueError`` before it builds anything.  Adds
    ``held_bytes`` (the storages alive when the step starts),
    ``output_bytes`` / ``alias_bytes`` (the step's outputs, and those that
    are its arguments' storages) and ``seconds``."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..roofline.op_cost import OpCost, local_tensors
    from ..train import OptimizerConfig, init_train_state, make_train_step
    from .mesh import mesh_device
    from .sharding import distribute_params

    scaled = fake if scaled is None else scaled
    if scaled and not fake:
        raise ValueError("a scaled count runs on fake tensors only: its "
                         "replayed regions' outputs hold no values")
    t0 = time.perf_counter()
    shape = ShapeConfig("cost", seq_len, global_batch, "train")
    with FakeTensorMode() if fake else contextlib.nullcontext():
        params = init_model(seed, cfg, device=mesh_device(mesh))
        params = distribute_params(params, mesh, cfg)
        state = init_train_state(params, cfg)
        del params
        step = make_train_step(cfg, opt_cfg or OptimizerConfig(),
                               microbatches=microbatches or cfg.microbatches,
                               mesh=mesh, donate=True)
        batch = {k: (torch.ones if k == "mask" else torch.zeros)(
            sh, dtype=dt, device=mesh_device(mesh))
            for k, (sh, dt) in make_batch_specs(cfg, shape).items()}
        cost = OpCost(mesh, scaled=scaled)
        cost.hold(state, batch)
        held = {id(t.untyped_storage())
                for t in local_tensors((state, batch))}
        with cost:
            new_state, metrics = step(state, batch)
        out = {}
        for t in local_tensors((new_state, metrics)):
            st = t.untyped_storage()
            out[id(st)] = (int(st.nbytes()), id(st) in held)
        res = cost.result()
    res["held_bytes"] = res.pop("argument_bytes")
    res["output_bytes"] = sum(n for n, _ in out.values())
    res["alias_bytes"] = sum(n for n, a in out.values() if a)
    res["seconds"] = time.perf_counter() - t0
    return res


def serve_params(params) -> dict:
    """The serving weights: bf16 for the ≥ 2-D fp32 leaves (the
    reference's ``build_cell``), the others as they are."""
    def cast(t):
        return t.to(torch.bfloat16) if t.dtype == torch.float32 and \
            t.ndim >= 2 else t
    return {k: serve_params(v) if isinstance(v, dict) else cast(v)
            for k, v in params.items()}


def _distribute(tree, specs, mesh):
    from .sharding import shard_leaf

    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], mesh) for k, v in tree.items()}
    return shard_leaf(tree, specs, mesh)


def cost_serve_step(cfg, mesh, shape, *, fake: bool = True, pos=None,
                    ready=None) -> dict:
    """``op_cost``'s count of one serving step of ``cfg`` (``shape``: a
    prefill or decode ``ShapeConfig``) on ``mesh``, under
    ``FakeTensorMode`` (``fake=False``: real tensors on the mesh's
    device), as the reference's ``build_cell`` serving branch builds it:
    ``serve_params`` of ``init_model(0)`` placed by ``param_specs``,
    the zero decode state of ``init_decode_state`` placed by
    ``state_specs`` (context-parallel for ``long_500k``: the caches'
    sequence over `data`), zero tokens (and encoder frames) placed by
    ``batch_specs``; then the mesh ``prefill`` (block-skipping causal) or
    ``decode_step`` at ``pos`` (default the last position) and
    ``serve_logits`` (vocab-sharded).  A fake run replays the measured
    units.  The state is donated: written in place, its storages are the
    step's output.  ``ready()``, when given, is called once the arguments
    are built, just before the step (a card run resets its peak memory
    there: building the serving weights from fp32 ones passes through more
    memory than the step holds).  Keys as :func:`cost_train_step`'s, and
    ``logits_shape``."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.transformer import (decode_step, mesh_params, prefill,
                                      serve_logits)
    from ..roofline.op_cost import OpCost, local_tensors
    from .mesh import mesh_device
    from .sharding import distribute_params

    t0 = time.perf_counter()
    b, s = shape.global_batch, shape.seq_len
    dev = mesh_device(mesh)
    with FakeTensorMode() if fake else contextlib.nullcontext():
        params = mesh_params(distribute_params(serve_params(
            init_model(0, cfg, device=dev)), mesh, cfg), cfg, mesh)
        enc_len = s if cfg.family == "encdec" else 0
        state = init_decode_state(cfg, b, s, torch.bfloat16,
                                  enc_len=enc_len, device=dev)
        state = _distribute(state, state_specs(
            state, mesh, cfg, global_batch=b,
            context_parallel=shape.name == "long_500k"), mesh)
        if shape.kind == "prefill":
            batch = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                           device=dev)}
            if cfg.family == "encdec":
                batch["enc_frames"] = torch.zeros(
                    (b, s, cfg.d_model), dtype=torch.bfloat16, device=dev)
        else:
            batch = {"tokens": torch.zeros((b, 1), dtype=torch.int32,
                                           device=dev)}
        batch = _distribute(batch, batch_specs(batch, mesh, global_batch=b,
                                               cfg=cfg), mesh)
        args = (params, state, batch)
        if shape.kind == "decode":
            pos_t = torch.tensor(s - 1 if pos is None else pos,
                                 dtype=torch.int32, device=dev)
            args += (pos_t,)
        if ready is not None:
            ready()
        cost = OpCost(mesh, scaled=fake)
        cost.hold(*args)
        held = {id(t.untyped_storage()) for t in local_tensors(args)}
        with cost:
            if shape.kind == "prefill":
                h, new_state = prefill(params, batch, cfg, state, mesh=mesh,
                                       skip_causal=True)
            else:
                h, new_state = decode_step(params, batch["tokens"], cfg,
                                           state, pos_t, mesh=mesh)
            logits = serve_logits(params, h, cfg, mesh=mesh,
                                  global_batch=b)
        out = {}
        for t in local_tensors((logits, new_state)):
            st = t.untyped_storage()
            out[id(st)] = (int(st.nbytes()), id(st) in held)
        res = cost.result()
        res["logits_shape"] = list(logits.shape)
    res["held_bytes"] = res.pop("argument_bytes")
    res["output_bytes"] = sum(n for n, _ in out.values())
    res["alias_bytes"] = sum(n for n, a in out.values() if a)
    res["seconds"] = time.perf_counter() - t0
    return res


def cost_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The cost of one production cell, in this process: rank 0 of a fake
    group of the mesh's size (the process must have no group)."""
    import torch.distributed as dist

    from .mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    size = ShapeMesh(PRODUCTION_SHAPES[MESHES[multi_pod]]).size
    fake_group(size)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        if shape.kind != "train":
            return cost_serve_step(cfg, mesh, shape)
        return cost_train_step(cfg, mesh, shape.global_batch, shape.seq_len)
    finally:
        dist.destroy_process_group()


def _src_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def cost_in_subprocess(arch: str, shape_name: str, multi_pod: bool, *,
                       timeout: float = 3600) -> dict:
    """:func:`cost_cell` in a fresh Python process (the fake group is that
    process's default group); raises with the child's error if it
    fails."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cost.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--cost-one", arch, shape_name, MESHES[multi_pod],
               "--out", out]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_src_root()] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=timeout)
        if r.returncode != 0 or not os.path.exists(out):
            tail = (r.stderr or r.stdout).strip().splitlines()[-12:]
            raise RuntimeError(f"cost run of {arch} × {shape_name} on "
                               f"{MESHES[multi_pod]} exited {r.returncode}:"
                               "\n" + "\n".join(tail))
        with open(out) as f:
            return json.load(f)


def cost_record(cfg, shape, chips: int, c: dict, params, arg_bytes: int,
                per_arg: dict) -> dict:
    """The reference's record keys from a cost run ``c``."""
    mf = model_flops_for(cfg, shape, params)
    terms = roofline(float(c["flops"]), float(c["dot_bytes"]),
                     float(c["coll_bytes"]), chips=chips, model_flops=mf,
                     coll_by_link=c["coll_by_link"])
    peak = int(c["peak_bytes"])
    held, out, alias = c["held_bytes"], c["output_bytes"], c["alias_bytes"]
    return {
        "flops_per_device": float(c["flops"]),
        "bytes_per_device": float(c["dot_bytes"]),
        "bytes_per_device_upper": float(c["bytes"]),
        "collectives": c["coll_by_op"],
        "collectives_by_axis": c["coll_by_axis"],
        "collectives_by_link": c["coll_by_link"],
        "collectives_top": c["coll_top"],
        "memory": {
            "argument_bytes": arg_bytes,
            "argument_bytes_by_arg": per_arg,
            "held_bytes": held,
            "output_bytes": out,
            "alias_bytes": alias,
            "temp_bytes": peak - held - (out - alias),
            "peak_estimate_bytes": peak,
        },
        "n_ops": c["n_ops"],
        "regions": c["regions"],
        "roofline": terms.as_dict(),
        "cost_s": round(c["seconds"], 3),
    }


def _margin(rec, device_bytes):
    """The bytes left on a device of ``device_bytes`` beside the cell's
    peak (its arguments when it has no cost) and ``HEADROOM_BYTES``, or
    None."""
    if device_bytes is None or rec.get("status") != "OK":
        return None
    need = rec["memory"]["peak_estimate_bytes" if "flops_per_device" in rec
                         else "argument_bytes"]
    return device_bytes - HEADROOM_BYTES - need


def _fit(rec, device_bytes) -> None:
    """Sets the record's ``device_bytes``, ``margin_bytes`` and ``fits``."""
    margin = _margin(rec, device_bytes)
    rec["device_bytes"] = device_bytes
    rec["headroom_bytes"] = HEADROOM_BYTES
    rec["margin_bytes"] = margin
    rec["fits"] = None if margin is None else margin >= 0


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, force=False,
             verbose=True, device_bytes=None, cost=True, costed=None) -> dict:
    """One cell's record (read back when recorded, unless ``force``, or
    unless it has no cost and ``cost`` asks for one).  ``costed``: the
    cell's cost run when the caller ran it (``cost_in_subprocess``)."""
    mesh_name = MESHES[multi_pod]
    out_dir = os.path.join(OUT_DIR, mesh_name)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    cfg = get_config(arch)
    want_cost = cost
    if os.path.exists(out_path) and not force and costed is None:
        with open(out_path) as f:
            rec = json.load(f)
        if rec["status"] != "OK" or not want_cost or \
                "flops_per_device" in rec:
            if rec["status"] == "OK":      # the fit on this device, kept
                _fit(rec, device_bytes)
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
            return rec

    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind}
    if shape_name not in cfg.shapes:
        rec["status"] = "SKIP"
        rec["reason"] = ("full-attention arch: long_500k requires "
                         "sub-quadratic mixer")
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    mesh = ShapeMesh(PRODUCTION_SHAPES[mesh_name])
    try:
        t0 = time.perf_counter()
        args = cell_args(cfg, shape, mesh)
        per_arg = {k: device_bytes_of(t, s, mesh)
                   for k, (t, s) in args.items()}
        total = sum(per_arg.values())
        params = args["params"][0]
        rec.update({
            "status": "OK",
            "chips": mesh.size,
            "build_s": round(time.perf_counter() - t0, 3),
            "n_params": count_params(params),
            "n_params_active": count_params(params, active_only=True,
                                            cfg=cfg),
            "memory": {"argument_bytes": total,
                       "argument_bytes_by_arg": per_arg},
        })
        if want_cost:
            c = costed if costed is not None else cost_in_subprocess(
                arch, shape_name, multi_pod)
            rec.update(cost_record(cfg, shape, mesh.size, c, params, total,
                                   per_arg))
        else:
            rec["cost"] = None
            rec["cost_reason"] = "args only: the cost was not asked for"
        _fit(rec, device_bytes)
        if verbose:
            line = (f"[{mesh_name}] {arch} × {shape_name}: OK "
                    f"args/dev={total / 2**30:.2f}GiB")
            if "roofline" in rec:
                t = rec["roofline"]
                line += (f" peak/dev={rec['memory']['peak_estimate_bytes'] / 2**30:.2f}GiB"
                         f" flops/dev={rec['flops_per_device']:.3e}"
                         f" dominant={t['dominant']}"
                         f" (c={t['compute_s'] * 1e3:.2f}ms"
                         f" m={t['memory_s'] * 1e3:.2f}ms"
                         f" coll={t['collective_s'] * 1e3:.2f}ms)"
                         f" cost_s={rec['cost_s']}")
            print(line + f" fits={rec['fits']} margin={rec['margin_bytes']}",
                  flush=True)
    except Exception as exc:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "FAIL"
        rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{mesh_name}] {arch} × {shape_name}: FAIL {rec['error']}",
                  flush=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def run_cells(cells, *, force=False, verbose=True, device_bytes=None,
              cost=True, jobs=1) -> list:
    """:func:`run_cell` over ``cells`` ((arch, shape, multi_pod) triples),
    the cost runs of those that need one ``jobs`` at a time (each a
    subprocess); records in ``cells``' order."""
    def needs(cell):
        arch, name, multi = cell
        if not (cost and name in get_config(arch).shapes):
            return False
        path = os.path.join(OUT_DIR, MESHES[multi], f"{arch}__{name}.json")
        if force or not os.path.exists(path):
            return True
        with open(path) as f:
            rec = json.load(f)
        return rec["status"] == "OK" and "flops_per_device" not in rec

    runs = {}
    with concurrent.futures.ThreadPoolExecutor(max(1, jobs)) as pool:
        futs = {pool.submit(cost_in_subprocess, *cell): cell
                for cell in cells if needs(cell)}
        for fut in concurrent.futures.as_completed(futs):
            try:
                runs[futs[fut]] = fut.result()
            except Exception as exc:  # noqa: BLE001 — run_cell records it
                runs[futs[fut]] = exc
    out = []
    for cell in cells:
        got = runs.get(cell)
        if isinstance(got, Exception):
            out.append(_failed(cell, got, verbose))
            continue
        out.append(run_cell(*cell, force=force or got is not None,
                            verbose=verbose, device_bytes=device_bytes,
                            cost=cost, costed=got))
    return out


def _failed(cell, exc, verbose) -> dict:
    arch, name, multi = cell
    rec = {"arch": arch, "shape": name, "mesh": MESHES[multi],
           "kind": SHAPES[name].kind, "status": "FAIL",
           "error": f"{type(exc).__name__}: {exc}"}
    out_dir = os.path.join(OUT_DIR, MESHES[multi])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        print(f"[{MESHES[multi]}] {arch} × {name}: FAIL {rec['error']}",
              flush=True)
    return rec


def _cost_one(arch, shape_name, mesh_name, out) -> int:
    multi = {v: k for k, v in MESHES.items()}[mesh_name]
    res = cost_cell(arch, shape_name, multi)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--args-only", action="store_true",
                    help="record the argument bytes only (no cost run)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cost runs at a time (one subprocess each)")
    ap.add_argument("--device-bytes", type=int, default=None,
                    help="one device's memory (default: the card's)")
    ap.add_argument("--cost-one", nargs=3, metavar=("ARCH", "SHAPE", "MESH"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cost_one:
        return _cost_one(*args.cost_one, args.out)

    dev_bytes = args.device_bytes or card_bytes()
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = [(arch, shape, multi) for multi in meshes for arch in archs
             for shape in shapes]
    recs = run_cells(cells, force=args.force, device_bytes=dev_bytes,
                     cost=not args.args_only, jobs=args.jobs)
    n = {"OK": 0, "SKIP": 0, "FAIL": 0}
    for rec in recs:
        n[rec["status"]] += 1
    fit = sum(bool(rec.get("fits")) for rec in recs)
    print(f"dry-run complete: {n['OK']} OK, {n['SKIP']} SKIP, "
          f"{n['FAIL']} FAIL; {fit} fit {dev_bytes} bytes", flush=True)
    return 1 if n["FAIL"] else 0


__all__ = ["cell_args", "count_params", "model_flops_for", "run_cell",
           "run_cells", "cost_train_step", "cost_serve_step", "serve_params",
           "HEADROOM_BYTES", "cost_cell",
           "cost_in_subprocess", "fake_group", "main"]


if __name__ == "__main__":
    raise SystemExit(main())

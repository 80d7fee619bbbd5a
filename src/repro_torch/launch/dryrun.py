"""Multi-pod dry run: the per-device memory of every cell, from shapes alone.

The port of ``repro.launch.dryrun``, the half that has a PyTorch meaning.
For every (architecture × input shape × production mesh) cell it builds
the step's arguments as fake tensors (``FakeTensorMode``: shapes and
dtypes, nothing allocated, no process group) as the reference's
``build_cell`` builds them —

* train: the fp32 params, the AdamW moments in ``cfg.opt_state_dtype``,
  the two step counters, and the batch of ``data.make_batch_specs``;
* prefill / decode: bf16 weights for the ≥ 2-D fp32 leaves (the other
  leaves keep their dtype), the decode state of ``init_decode_state``
  (context-parallel for ``long_500k``), and the tokens (plus the encoder
  frames of an encoder-decoder's prefill, and decode's position) —

places each under ``launch.sharding``'s specs on the production mesh
(``launch.mesh.ShapeMesh``: 16 × 16 or 2 × 16 × 16), and records one
device's bytes of them, ``n_params``, and whether the cell fits a device
of ``--device-bytes`` (default: the card's ``total_memory`` when there is
a card).  Full-attention architectures skip ``long_500k``, as in the
reference.  Records go to ``build/dryrun/<mesh>/<arch>__<shape>.json``;
a re-run reads a recorded cell unless ``--force``.

The reference's other half has no counterpart: it lowers and compiles
each cell's XLA program for 512 devices and records ``cost_analysis``,
``memory_analysis`` (temporaries included), the HLO's collective bytes and
the roofline terms (``repro.roofline``).  The port compiles no XLA
program, and eager PyTorch has no whole-step program to analyse, so the
bytes here are the step's arguments only — a floor under the reference's
``peak_estimate_bytes``, not an estimate of the peak.

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] \\
      [--shape S] [--mesh single|multi|both] [--force] [--device-bytes N]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, SHAPES, get_config
from ..data.pipeline import make_batch_specs
from ..models.transformer import init_decode_state, init_model, tree_leaves
from .mesh import PRODUCTION_SHAPES, ShapeMesh
from .sharding import (_map_with_path, batch_specs, local_size_bytes,
                       param_specs, state_specs)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")
MESHES = {False: "single_pod_16x16", True: "multi_pod_2x16x16"}


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


def count_params(params, *, active_only=False, cfg=None) -> float:
    """Elements of every leaf (an expert leaf's scaled by top_k / E when
    ``active_only``), the reference's ``roofline.analysis.count_params``."""
    total = []

    def one(path, leaf):
        n = float(leaf.numel())
        if active_only and path[-1].startswith("we_"):
            n *= cfg.top_k / cfg.n_experts
        total.append(n)

    _map_with_path(one, params)
    return sum(total)


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


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, force=False,
             verbose=True, device_bytes=None) -> dict:
    mesh_name = MESHES[multi_pod]
    out_dir = os.path.join(OUT_DIR, mesh_name)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            rec = json.load(f)
        if rec["status"] == "OK":           # fits: against this device
            rec["device_bytes"] = device_bytes
            rec["fits"] = (None if device_bytes is None
                           else rec["bytes_per_device"] <= device_bytes)
        return rec

    cfg = get_config(arch)
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
            "bytes_per_device": total,
            "bytes_per_device_by_arg": per_arg,
            "n_params": count_params(params),
            "n_params_active": count_params(params, active_only=True,
                                            cfg=cfg),
            "device_bytes": device_bytes,
            "fits": None if device_bytes is None else total <= device_bytes,
        })
        if verbose:
            print(f"[{mesh_name}] {arch} × {shape_name}: OK "
                  f"args/dev={total / 2**30:.2f}GiB fits={rec['fits']}",
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device-bytes", type=int, default=None,
                    help="one device's memory (default: the card's)")
    args = ap.parse_args(argv)

    dev_bytes = args.device_bytes or card_bytes()
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n = {"OK": 0, "SKIP": 0, "FAIL": 0}
    fit = 0
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, multi, force=args.force,
                               device_bytes=dev_bytes)
                n[rec["status"]] += 1
                fit += bool(rec.get("fits"))
    print(f"dry-run complete: {n['OK']} OK, {n['SKIP']} SKIP, "
          f"{n['FAIL']} FAIL; {fit} fit {dev_bytes} bytes", flush=True)
    return 1 if n["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

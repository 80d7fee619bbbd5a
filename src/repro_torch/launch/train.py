"""Training entry point.

The port of ``repro.launch.train``: build the mesh → shard the state →
``ResilientTrainer`` loop with async checkpoints.  The reference's flags
plus ``--device`` (default ``cuda``).  CPU example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --smoke --steps 20 --global-batch 8 --seq-len 128 \\
      --ckpt-dir build/train_ckpt --device cpu

A run resumes from the latest checkpoint in ``--ckpt-dir``; without the
flag it writes to a new directory under ``TMPDIR``, so that it never
resumes from another run's state.

With ``--data-par D --model-par M`` above 1 the step runs on a (data=D,
model=M) ``DeviceMesh`` of D·M ranks, one process a device, under a
process group that is already up — ``torchrun``'s environment, e.g.

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3_2_1b --smoke --data-par 2 --model-par 2 --device cpu

(gloo on the CPU, NCCL on cards), or one the caller made before calling
:func:`main`.  The state is sharded by ``launch.sharding``'s rules and the
MoE layers route per shard (``models.shard_ctx``'s context); see
``train.train_step`` for how the step computes on the mesh.
``build_trainer`` compiles nothing: the step updates the state in place
(``donate=True``), the analogue of the reference's
``donate_argnums=(0,)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.plan import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenDataset
from repro_torch.launch.mesh import make_host_mesh, mesh_device
from repro_torch.launch.sharding import distribute_params
from repro_torch.models import init_model
from repro_torch.train import (CheckpointManager, OptimizerConfig,
                               ResilientTrainer, init_train_state,
                               make_train_step)


def build_trainer(cfg, opt_cfg, *, mesh=None, device=None, global_batch,
                  seq_len, ckpt_dir, ckpt_every=50, seed=0):
    """(trainer, state): a ``ResilientTrainer`` over ``cfg``'s train step
    (``cfg.microbatches`` slices, in place) on ``device`` (default
    ``cuda``), with weights from ``seed`` and the synthetic token pipeline
    keyed by ``seed``.  With a ``mesh`` the state is sharded over it (its
    leaves ``DTensor``s on this rank's device) and every rank feeds the
    same global batch, of which the step takes this rank's block (the step
    sets the sharding context for its own run)."""
    if mesh is not None:
        device = mesh_device(mesh)
    device = resolve_device(device)
    params = init_model(seed, cfg, device=device)
    if mesh is not None:
        params = distribute_params(params, mesh, cfg)
    state = init_train_state(params, cfg)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=cfg.microbatches,
                              donate=True, mesh=mesh)
    ds = SyntheticTokenDataset(vocab_size=cfg.vocab_size, seq_len=seq_len,
                               global_batch=global_batch, seed=seed)

    def batch_fn(step: int):
        batch = ds.train_inputs(step)
        if cfg.family == "encdec":
            rng = np.random.default_rng(step)
            batch["enc_frames"] = rng.standard_normal(
                (global_batch, seq_len, cfg.d_model)).astype(np.float32)
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    ckpt = CheckpointManager(ckpt_dir)
    trainer = ResilientTrainer(step_fn=step_fn, batch_fn=batch_fn, ckpt=ckpt,
                               ckpt_every=ckpt_every)
    return trainer, state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from if it holds "
                         "one (default: a new directory under TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = None
    if args.data_par * args.model_par > 1:
        if not dist.is_initialized():       # torchrun's environment
            dist.init_process_group(
                "nccl" if torch.device(args.device).type == "cuda"
                else "gloo")
        mesh = make_host_mesh(args.data_par, args.model_par,
                              torch.device(args.device).type)
    lead = mesh is None or dist.get_rank() == 0
    ckpt_dir = [args.ckpt_dir or (tempfile.mkdtemp(prefix="repro_torch_ckpt_")
                                  if lead else None)]
    if mesh is not None:                    # every rank writes to rank 0's
        dist.broadcast_object_list(ckpt_dir, src=0)
    ckpt_dir = ckpt_dir[0]
    if lead:
        print(f"checkpoints: {ckpt_dir}")
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, microbatches=1)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=5,
                              total_steps=args.steps)
    trainer, state = build_trainer(
        cfg, opt_cfg, mesh=mesh, device=args.device,
        global_batch=args.global_batch, seq_len=args.seq_len,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every)
    state, history = trainer.run(state, 0, args.steps)
    if lead:
        for h in history[:3] + history[-3:]:
            print(f"step {h['step']:5d} loss {h['loss']:.4f} "
                  f"grad_norm {h['grad_norm']:.3f} "
                  f"{h['seconds']*1e3:.0f}ms")
        print(f"final loss: {history[-1]['loss']:.4f} "
              f"({len(history)} steps, straggler flags: "
              f"{len(trainer.watchdog.flagged)})")
    return history


if __name__ == "__main__":
    main()

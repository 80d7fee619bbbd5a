"""Training entry point.

The port of ``repro.launch.train``: build the state → ``ResilientTrainer``
loop with async checkpoints, on one device.  The reference's flags plus
``--device`` (default ``cuda``).  CPU example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --smoke --steps 20 --global-batch 8 --seq-len 128 \\
      --ckpt-dir build/train_ckpt --device cpu

A run resumes from the latest checkpoint in ``--ckpt-dir``; without the
flag it writes to a new directory under ``TMPDIR``, so that it never
resumes from another run's state.

The reference shards the state over a device mesh (``--data-par``,
``--model-par``, ``launch/mesh.py``, ``launch/sharding.py``) and pins
activation shardings (``set_sharding_context``, ``shard_act``); the port
has no mesh path yet (ROADMAP Queue 1 item 11), so both flags must stay 1
and the step runs on one device.  ``build_trainer`` jits nothing: the
step updates the state in place (``donate=True``), the analogue of the
reference's ``donate_argnums=(0,)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.api.plan import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenDataset
from repro_torch.models import init_model
from repro_torch.train import (CheckpointManager, OptimizerConfig,
                               ResilientTrainer, init_train_state,
                               make_train_step)


def build_trainer(cfg, opt_cfg, *, device=None, global_batch, seq_len,
                  ckpt_dir, ckpt_every=50, seed=0):
    """(trainer, state): a ``ResilientTrainer`` over ``cfg``'s train step
    (``cfg.microbatches`` slices, in place) on ``device`` (default
    ``cuda``), with weights from ``seed`` and the synthetic token pipeline
    keyed by ``seed``."""
    device = resolve_device(device)
    params = init_model(seed, cfg, device=device)
    state = init_train_state(params, cfg)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=cfg.microbatches,
                              donate=True)
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
    if args.data_par != 1 or args.model_par != 1:
        raise NotImplementedError(
            "--data-par/--model-par above 1 need the mesh and sharding "
            "layer, which is not ported yet (ROADMAP Queue 1 item 11)")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    print(f"checkpoints: {ckpt_dir}")
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, microbatches=1)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=5,
                              total_steps=args.steps)
    trainer, state = build_trainer(
        cfg, opt_cfg, device=args.device, global_batch=args.global_batch,
        seq_len=args.seq_len, ckpt_dir=ckpt_dir,
        ckpt_every=args.ckpt_every)
    state, history = trainer.run(state, 0, args.steps)
    for h in history[:3] + history[-3:]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"grad_norm {h['grad_norm']:.3f} {h['seconds']*1e3:.0f}ms")
    print(f"final loss: {history[-1]['loss']:.4f} "
          f"({len(history)} steps, straggler flags: "
          f"{len(trainer.watchdog.flagged)})")
    return history


if __name__ == "__main__":
    main()

"""End-to-end training example: trains a smoke-scale LM for a few dozen steps
through the full path (state → resilient loop → async checkpoints), then
resumes from the checkpoint to prove restart-consistency.

The port of ``examples/train_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 30] \\
      [--device cpu]
"""

import argparse
import shutil
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    flags = ["--arch", args.arch, "--smoke", "--global-batch", "8",
             "--seq-len", "128", "--ckpt-dir", ckpt, "--ckpt-every", "10",
             "--device", args.device]
    try:
        first = train.main(flags + ["--steps", str(args.steps)])
        # the same directory again: the run resumes at its last checkpoint
        # and trains on from there
        resumed = train.main(flags + ["--steps", str(args.steps // 2)])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return first, resumed


if __name__ == "__main__":
    main()

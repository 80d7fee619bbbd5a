"""Serving CLI: batched requests through the continuous-batching engine.

The port of ``repro.launch.serve``, with the same flags plus ``--device``
(default ``cuda``).  CPU demo / integration shape:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \\
      --smoke --requests 12 --batch 4 --max-new 8 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api.plan import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_model(0, cfg, device=device)
    engine = ServeEngine(params, cfg, batch=args.batch, max_len=args.max_len,
                         max_prompt=args.max_prompt, device=device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(4, args.max_prompt))
        engine.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen,
                                       dtype=np.int32),
            max_new_tokens=args.max_new, temperature=args.temperature))
    done = engine.run_until_done()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in done)
    for r in done[:4]:
        print(f"req {r.uid}: {len(r.generated)} tokens -> {r.generated[:8]}")
    print(f"served {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s, batch={args.batch})")
    return done


if __name__ == "__main__":
    main()

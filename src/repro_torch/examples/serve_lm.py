"""End-to-end serving example: a small model serves batched requests through
the continuous-batching engine.

The port of ``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    return serve.main(["--arch", "llama3_2_1b", "--smoke", "--requests",
                       "12", "--batch", "4", "--max-new", "8",
                       "--device", dev])


if __name__ == "__main__":
    main()

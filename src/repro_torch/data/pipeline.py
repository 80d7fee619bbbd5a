"""Deterministic synthetic token pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only; its batches
are bit-identical to the reference's):

* **stateless indexing** — `batch_at(step)` is a pure function of
  (seed, step), so restart-from-checkpoint resumes the exact sample order
  with no iterator state to persist ("skip-to-step" is free);
* **host sharding** — each host materializes only its slice of the global
  batch (`host_slice`);
* **deterministic across restarts & host counts** — counter-based PRNG
  (Philox) keyed by (seed, step).

Token distribution is Zipf-like (natural-language-ish unigram statistics) so
softmax/router code paths see realistic skew instead of uniform noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticTokenDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, 0, step]))

    def batch_at(self, step: int) -> np.ndarray:
        """Full global batch for ``step``: (global_batch, seq_len) int32."""
        rng = self._rng(step)
        # inverse-CDF Zipf over a finite vocab (vectorized, exact)
        u = rng.random((self.global_batch, self.seq_len))
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        w = 1.0 / ranks ** self.zipf_a
        cdf = np.cumsum(w) / w.sum()
        tokens = np.searchsorted(cdf, u).astype(np.int32)
        return np.minimum(tokens, self.vocab_size - 1)

    def host_slice(self, step: int, host_id: int, n_hosts: int) -> np.ndarray:
        """The rows of ``batch_at(step)`` owned by ``host_id``."""
        if self.global_batch % n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {n_hosts} hosts")
        rows = self.global_batch // n_hosts
        lo = host_id * rows
        return self.batch_at(step)[lo:lo + rows]

    def train_inputs(self, step: int) -> dict:
        """tokens + shifted labels + mask (last position masked)."""
        tokens = self.batch_at(step)
        labels = np.roll(tokens, -1, axis=1)
        mask = np.ones_like(tokens, dtype=np.float32)
        mask[:, -1] = 0.0
        return {"tokens": tokens, "labels": labels, "mask": mask}


def make_batch_specs(cfg, shape) -> dict:
    """``{name: (shape, torch.dtype)}`` of one global batch (the
    reference's ``jax.ShapeDtypeStruct`` stand-ins)."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": ((b, s), torch.int32),
             "labels": ((b, s), torch.int32),
             "mask": ((b, s), torch.float32)}
    if cfg.family == "encdec":
        specs["enc_frames"] = ((b, s, cfg.d_model), getattr(torch, cfg.dtype))
    return specs

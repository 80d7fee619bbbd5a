"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B; unverified].  16L d2048 32H
(kv=8) d_ff 8192, vocab 128256, tied embeddings."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3_2_1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256,
    unit_pattern=(("attn", "mlp"),),
    tie_embeddings=True,
    rope_theta=500000.0,
    microbatches=2,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, dtype="float32", max_position=4096)

"""yi-6b [arXiv:2403.04652; hf].  Llama-arch GQA: 32L d4096 32H (kv=4)
d_ff 11008, vocab 64000."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi_6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    unit_pattern=(("attn", "mlp"),),
    rope_theta=5000000.0,
    fsdp=True, microbatches=4,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, fsdp=False, dtype="float32",
    max_position=4096)

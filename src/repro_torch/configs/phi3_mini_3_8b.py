"""phi3-mini-3.8b [arXiv:2404.14219; unverified].  32L d3072 32H (kv=32,
MHA) d_ff 8192, vocab 32064, RoPE + SwiGLU."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3_mini_3_8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    unit_pattern=(("attn", "mlp"),),
    rope_theta=10000.0,
    fsdp=True, microbatches=4,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, fsdp=False, dtype="float32",
    max_position=4096)

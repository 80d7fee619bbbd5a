"""moonshot-v1-16b-a3b — Moonlight-16B-A3B-style MoE
[hf:moonshotai/Moonlight-16B-A3B].  48L d2048 16H (kv=16) expert-d_ff 1408,
vocab 163840, MoE 64 experts top-6."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot_v1_16b_a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163840,
    unit_pattern=(("attn", "moe"),),
    n_experts=64, top_k=6, moe_sharding="expert",
    rope_theta=50000.0,
    fsdp=True, microbatches=4,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=96, vocab_size=512, n_experts=4, top_k=2, fsdp=False,
    dtype="float32", max_position=4096)

"""rwkv6-7b "Finch" [arXiv:2404.05892; hf].  32L d4096 attention-free
(data-dependent decay), channel-mix d_ff 14336, vocab 65536.

Sub-quadratic (recurrent state) ⇒ runs the long_500k cell."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    unit_pattern=(("rwkv", "rwkv_cm"),),
    rwkv_head_size=64,
    norm="layernorm", pos_embedding="none",
    fsdp=True, microbatches=4,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, rwkv_head_size=16, fsdp=False,
    dtype="float32", max_position=4096)

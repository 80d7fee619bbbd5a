"""chameleon-34b [arXiv:2405.09818; unverified].  Early-fusion VLM: 48L
d8192 64H (kv=8) d_ff 22016, vocab 65536.  Image tokens are ordinary VQ
codebook ids inside the vocab (frontend stub); QK-norm per the paper."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon_34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536,
    unit_pattern=(("attn", "mlp"),),
    qk_norm=True,
    rope_theta=10000.0,
    frontend="vq_stub",
    fsdp=True, act_sharding="sp", microbatches=8,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, fsdp=False, dtype="float32",
    max_position=4096)

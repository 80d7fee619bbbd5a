"""gemma2-2b [arXiv:2408.00118; hf].  26L d2304 8H (kv=4) d_ff 9216,
vocab 256000; local(4096)/global alternating attention, attn softcap 50,
final softcap 30, GeGLU, sandwich (post) norms, tied + scaled embeddings."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2_2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    unit_pattern=(("attn_local", "mlp"), ("attn", "mlp")),
    window_size=4096, attn_softcap=50.0, final_softcap=30.0,
    act="geglu", post_norm=True, tie_embeddings=True, embed_scale=True,
    rope_theta=10000.0,
    microbatches=2,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, window_size=64, dtype="float32",
    max_position=4096)

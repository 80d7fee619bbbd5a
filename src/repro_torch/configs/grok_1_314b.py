"""grok-1-314b [hf:xai-org/grok-1; unverified].  64L d6144 48H (kv=8)
d_ff 32768, vocab 131072, MoE 8 experts top-2.

E=8 < TP axis (16) ⇒ ``moe_sharding="ffn"``: experts replicated over `model`,
tensor parallel inside each expert.  Optimizer state in bf16
(distributed-optimizer trick) so 314B × (4+2+2)B fits 256 × 16 GiB."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok_1_314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    unit_pattern=(("attn", "moe"),),
    n_experts=8, top_k=2, moe_sharding="ffn",
    attn_softcap=30.0,               # grok uses attn logit softcap
    rope_theta=10000.0,
    fsdp=True, opt_state_dtype="bfloat16", act_sharding="sp", microbatches=8,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, n_experts=4, top_k=2, fsdp=False,
    dtype="float32", opt_state_dtype="float32", max_position=4096)

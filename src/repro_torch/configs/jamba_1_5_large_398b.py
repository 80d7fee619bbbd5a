"""jamba-1.5-large-398b [arXiv:2403.19887; hf].  72L d8192 64H (kv=8)
d_ff 24576, vocab 65536; Mamba:attention 7:1 interleave, MoE (16e top-2)
every 2nd layer.

Unit = 8 layers (attention at index 3, Mamba elsewhere; MoE on odd indices)
— 9 scanned units.  Hybrid (recurrent majority) ⇒ runs long_500k with the
attention KV cache context-parallel over the `data` axis.  Optimizer state
bf16 (398B params on 256 × 16 GiB)."""

import dataclasses

from .base import ModelConfig

_UNIT = tuple(
    ("attn" if i == 3 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba_1_5_large_398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    unit_pattern=_UNIT,
    n_experts=16, top_k=2, moe_sharding="expert",
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    pos_embedding="none",            # Jamba: no explicit positional encoding
    fsdp=True, opt_state_dtype="bfloat16", act_sharding="sp", microbatches=16,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, n_experts=4, top_k=2, mamba_d_state=8,
    fsdp=False, dtype="float32", opt_state_dtype="float32",
    max_position=4096)

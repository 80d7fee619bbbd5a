"""whisper-tiny [arXiv:2212.04356; unverified].  Enc-dec, 4+4L d384 6H
(kv=6) d_ff 1536, vocab 51865; conv frontend is a STUB per assignment —
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).

Non-gated GELU MLP, LayerNorm, learned positions (Whisper fidelity).
Enc-dec with full attention ⇒ long_500k skipped; decode shapes run with a
decoder KV cache + cached encoder cross-KV."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    unit_pattern=(("attn_cross", "mlp"),),
    n_enc_layers=4, enc_unit_pattern=(("attn_bidir", "mlp"),),
    act="gelu", norm="layernorm", pos_embedding="learned",
    max_position=33536, frontend="audio_stub",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, dtype="float32",
    max_position=4096)

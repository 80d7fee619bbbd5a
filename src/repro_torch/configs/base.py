"""Model configuration schema + registry for the 10 assigned architectures.

The port's own copy of ``repro.configs.base`` (dimensions only: nothing is
downloaded, and the port imports nothing of the JAX package).  Each
architecture file in this package defines ``CONFIG`` (the exact published
shape) and ``SMOKE`` (a reduced same-family config for CPU tests).  The
registry maps ``--arch <id>`` to them.  ``dtype`` and ``param_dtype`` stay
strings; ``models.layers`` maps them to torch dtypes.

A model is a stack of *units*; a unit is a tuple of *(mixer, ffn)* blocks and
is the repeating element the model loops over (heterogeneous layer
patterns — Gemma-2 local/global alternation, Jamba 1:7 attn:mamba with MoE
every 2nd layer — become homogeneous at unit granularity).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# mixer kinds: attn (causal global), attn_local (sliding window), attn_bidir
# (encoder), attn_cross (causal self + cross to encoder), mamba, rwkv
# ffn kinds: mlp, moe, rwkv_cm, none
Block = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    unit_pattern: Tuple[Block, ...] = (("attn", "mlp"),)
    # attention
    window_size: int = 0             # for attn_local
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"      # rope | learned | none
    max_position: int = 1 << 20
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_sharding: str = "expert"     # expert (E % tp == 0) | ffn (shard d_ff)
    router_aux_coef: float = 0.01
    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 → d_model // 16
    # rwkv
    rwkv_head_size: int = 64
    # enc-dec
    n_enc_layers: int = 0
    enc_unit_pattern: Tuple[Block, ...] = ()
    frontend: str = "none"           # none | audio_stub | vq_stub
    # norms / activations / embeddings
    act: str = "swiglu"              # swiglu | geglu | gelu (non-gated)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    post_norm: bool = False          # gemma-2 sandwich norms
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: x *= sqrt(d_model)
    # numerics / memory
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"
    remat: bool = True
    # distribution
    fsdp: bool = False               # shard params/opt over data(+pod) axes
    act_sharding: str = "dp"         # dp | sp (Megatron sequence parallel)
    microbatches: int = 1            # grad-accumulation slices (train cells)
    dp_over_model: bool = False      # pure-DP(+ZeRO): batch over BOTH axes,
    # TP disabled — right config for models that fit one chip (≤~2B);
    # turns per-layer TP all-reduces into a single grad reduce (§Perf)
    # assigned input shapes this arch runs (cells); long_500k only for
    # sub-quadratic families
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.unit_pattern)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(self.d_model // 16, 1)

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def validate(self) -> None:
        assert self.n_layers % len(self.unit_pattern) == 0, (
            self.name, "layers not divisible by unit length")
        if self.family == "encdec":
            assert self.n_enc_layers and self.enc_unit_pattern
        for mixer, ffn in self.unit_pattern:
            if ffn == "moe":
                assert self.n_experts > 0 and self.top_k > 0
            if mixer == "rwkv":
                assert self.d_model % self.rwkv_head_size == 0


# ---------------------------------------------------------------------------
# assigned input shapes (the 4 global cells; batch/seq per spec)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "moonshot_v1_16b_a3b", "grok_1_314b", "yi_6b", "gemma2_2b",
    "phi3_mini_3_8b", "llama3_2_1b", "rwkv6_7b", "jamba_1_5_large_398b",
    "whisper_tiny", "chameleon_34b",
]


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    cfg.validate()
    return cfg


def list_configs() -> list[str]:
    return list(ARCH_IDS)

"""LM substrate: layers, attention, MoE, Mamba, RWKV-6, transformer spine.

The port of ``repro.models``; all ten assigned architectures run.
"""

from . import attention, layers, mamba, moe, rwkv, transformer
from .transformer import (decode_step, forward, init_decode_state, init_model,
                          prefill)

__all__ = ["attention", "layers", "mamba", "moe", "rwkv", "transformer",
           "decode_step", "forward", "init_decode_state", "init_model",
           "prefill"]

"""LM substrate: layers, attention, transformer spine.

The port of ``repro.models`` for the attention families; ``moe``,
``mamba`` and ``rwkv`` come with the next slice (ROADMAP Queue 1 item 9).
"""

from . import attention, layers, transformer
from .transformer import (decode_step, forward, init_decode_state, init_model,
                          prefill)

__all__ = ["attention", "layers", "transformer", "decode_step", "forward",
           "init_decode_state", "init_model", "prefill"]

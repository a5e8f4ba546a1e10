"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Modules import no GPU toolchain at import time: a kernel is built
(``build.py``) and loaded the first time a CUDA tensor reaches it.
"""
from .mx_attention import (mx_attention_ragged_fused,
                           mx_attention_ragged_fused_plain)

__all__ = ["mx_attention_ragged_fused", "mx_attention_ragged_fused_plain"]

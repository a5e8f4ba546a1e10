"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Modules import no GPU toolchain at import time: a kernel is built
(``build.py``) and loaded the first time a CUDA tensor reaches it. The
entry points ``ops.mx_matmul`` and ``mx_quantize.mx_quantize`` are not
re-exported here, where their names would hide their modules.
"""
from .mx_attention import (gather_kv_pages, gather_kv_pages_plain,
                           mx_attention_decode, mx_attention_decode_fused,
                           mx_attention_decode_paged,
                           mx_attention_decode_plain,
                           mx_attention_prefill_fused,
                           mx_attention_prefill_fused_plain,
                           mx_attention_ragged_fused,
                           mx_attention_ragged_fused_plain,
                           mx_attention_verify_fused,
                           mx_attention_verify_fused_plain)
from .mx_matmul import mx_matmul_dgrad, mx_matmul_vv, mx_matmul_wo
from .mx_megakernel import mx_megakernel_step, mx_megakernel_step_plain
from .mx_repack import mx_repack_pages, mx_repack_pages_plain
from .ops import mx_matmul_trainable, quantize_pallas
from .ref import mx_attention_decode_ref

__all__ = ["gather_kv_pages", "gather_kv_pages_plain",
           "mx_attention_decode", "mx_attention_decode_fused",
           "mx_attention_decode_paged", "mx_attention_decode_plain",
           "mx_attention_decode_ref", "mx_attention_prefill_fused",
           "mx_attention_prefill_fused_plain", "mx_attention_ragged_fused",
           "mx_attention_ragged_fused_plain", "mx_attention_verify_fused",
           "mx_attention_verify_fused_plain", "mx_matmul_dgrad",
           "mx_matmul_trainable", "mx_matmul_vv", "mx_matmul_wo",
           "mx_megakernel_step", "mx_megakernel_step_plain",
           "mx_repack_pages", "mx_repack_pages_plain", "quantize_pallas"]

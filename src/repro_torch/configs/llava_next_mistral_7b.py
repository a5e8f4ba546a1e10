"""llava-next-mistral-7b [vlm]: mistral-7b backbone, anyres vision stub
(port of ``repro.configs.llava_next_mistral_7b``).

32L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. The vision frontend
(anyres tiling -> patch embeddings) is a stub, as in the reference:
``model.forward``, ``prefill`` and ``decode_step`` take precomputed
(B, S, d_model) ``embeds``; the engines serve it from token ids.
"""
from repro_torch.core import MXFP8
from repro_torch.nn import BlockDef, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        d_model=4096, vocab_size=32000,
        pattern=(BlockDef("attn"),), num_groups=32,
        num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, ffn_kind="swiglu",
        rope_theta=1e6, tied_embeddings=False,
        quant=MXFP8,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, vocab_size=512, num_groups=2,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        quant=MXFP8.replace(block_size=16),
    )

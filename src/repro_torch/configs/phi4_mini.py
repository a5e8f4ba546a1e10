"""phi4-mini-3.8b [dense]: RoPE SwiGLU GQA decoder (port of
``repro.configs.phi4_mini``).

32L d_model=3072 24H (GQA kv=8, head_dim 128) d_ff=8192 vocab=200064
[arXiv:2412.08905; hf].
"""
from repro_torch.core import MXFP8
from repro_torch.nn import BlockDef, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        d_model=3072, vocab_size=200064,
        pattern=(BlockDef("attn"),), num_groups=32,
        num_heads=24, num_kv_heads=8, head_dim=128,
        d_ff=8192, ffn_kind="swiglu",
        quant=MXFP8,
        source="arXiv:2412.08905; hf",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, vocab_size=512, num_groups=2,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        quant=MXFP8.replace(block_size=16),
    )

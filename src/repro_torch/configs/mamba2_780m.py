"""mamba2-780m [ssm]: SSD (state-space duality), attention-free (port of
``repro.configs.mamba2_780m``).

48L d_model=1536 (d_inner=3072, headdim 64 -> 48 heads, d_state=128)
vocab=50280 [arXiv:2405.21060; unverified]. No FFN blocks (mamba stacks
mixer-only layers). Attention-free -> long_500k eligible.
"""
from repro_torch.core import MXFP8
from repro_torch.nn import BlockDef, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        d_model=1536, vocab_size=50280,
        pattern=(BlockDef("ssd", ffn="none"),), num_groups=48,
        d_inner=3072, headdim=64, d_state=128, ngroups=1,
        conv_width=4, ssd_chunk=256,
        quant=MXFP8,
        source="arXiv:2405.21060; unverified",
        sub_quadratic=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, vocab_size=512, num_groups=2,
        d_inner=128, headdim=16, d_state=32, ssd_chunk=8,
        quant=MXFP8.replace(block_size=16),
    )

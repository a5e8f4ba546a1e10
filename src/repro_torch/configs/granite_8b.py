"""granite-8b [dense]: llama-arch code model (port of
``repro.configs.granite_8b``).

36L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=14336 vocab=49152
[arXiv:2405.04324; hf].
"""
from repro_torch.core import MXFP8
from repro_torch.nn import BlockDef, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense",
        d_model=4096, vocab_size=49152,
        pattern=(BlockDef("attn"),), num_groups=36,
        num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, ffn_kind="swiglu",
        rope_theta=1e7, tied_embeddings=False,
        quant=MXFP8,
        source="arXiv:2405.04324; hf",
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, vocab_size=512, num_groups=2,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        quant=MXFP8.replace(block_size=16),
    )

"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention (port of
``repro.configs.mixtral_8x22b``).

56L d_model=6144 48H (GQA kv=8, head_dim 128) d_ff_expert=16384
vocab=32768 [arXiv:2401.04088; hf]; every layer windowed at 4096.
"""
from repro_torch.core import MXFP8
from repro_torch.nn import BlockDef, ModelConfig

WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        d_model=6144, vocab_size=32768,
        pattern=(BlockDef("attn", window=WINDOW, ffn="moe"),),
        num_groups=56,
        num_heads=48, num_kv_heads=8, head_dim=128,
        num_experts=8, top_k=2, d_ff_expert=16384,
        rope_theta=1e6, tied_embeddings=False,
        quant=MXFP8,
        source="arXiv:2401.04088; hf",
        sub_quadratic=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, vocab_size=512, num_groups=2,
        num_heads=4, num_kv_heads=2, head_dim=16,
        num_experts=4, top_k=2, d_ff_expert=64,
        pattern=(BlockDef("attn", window=8, ffn="moe"),),
        quant=MXFP8.replace(block_size=16),
    )

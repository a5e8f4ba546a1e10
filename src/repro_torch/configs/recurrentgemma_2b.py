"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2
attn:recurrent (port of ``repro.configs.recurrentgemma_2b``).

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 (GeGLU) vocab=256000
[arXiv:2402.19427; hf]. Pattern (rec, rec, local-attn) x 8 groups + 2
trailing recurrent layers (26 = 3*8 + 2). Local window 2048. Sub-quadratic
-> eligible for long_500k.
"""
from repro_torch.core import MXFP8
from repro_torch.nn import BlockDef, ModelConfig

WINDOW = 2048


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        d_model=2560, vocab_size=256000,
        pattern=(BlockDef("rglru"), BlockDef("rglru"),
                 BlockDef("attn", window=WINDOW)),
        num_groups=8,
        epilogue=(BlockDef("rglru"), BlockDef("rglru")),
        num_heads=10, num_kv_heads=1, head_dim=256,
        d_ff=7680, ffn_kind="geglu",
        rnn_width=2560, conv_width=4,
        scale_embeds_by_sqrt_dim=True,
        quant=MXFP8,
        source="arXiv:2402.19427; hf",
        sub_quadratic=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, vocab_size=512, num_groups=1, epilogue=(),
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128, rnn_width=64,
        pattern=(BlockDef("rglru"), BlockDef("rglru"),
                 BlockDef("attn", window=8)),
        quant=MXFP8.replace(block_size=16),
    )

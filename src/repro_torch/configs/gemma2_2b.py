"""gemma2-2b [dense]: local/global alternating attention, logit softcaps
(port of ``repro.configs.gemma2_2b``).

26L d_model=2304 8H (GQA kv=4, head_dim 256) d_ff=9216 (GeGLU) vocab=256000
[arXiv:2408.00118; hf]. Local window 4096; attn softcap 50, final logit
softcap 30; pre+post sandwich norms. Global layers are full attention ->
not eligible for long_500k.
"""
from repro_torch.core import MXFP8
from repro_torch.nn import BlockDef, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        d_model=2304, vocab_size=256000,
        pattern=(BlockDef("attn", window=4096), BlockDef("attn")),
        num_groups=13,
        num_heads=8, num_kv_heads=4, head_dim=256,
        d_ff=9216, ffn_kind="geglu",
        attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
        scale_embeds_by_sqrt_dim=True,
        quant=MXFP8,
        source="arXiv:2408.00118; hf",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, vocab_size=512, num_groups=1,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        pattern=(BlockDef("attn", window=8), BlockDef("attn")),
        quant=MXFP8.replace(block_size=16),
    )

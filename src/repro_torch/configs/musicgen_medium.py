"""musicgen-medium [audio]: decoder-only over EnCodec tokens, 4 codebooks
(port of ``repro.configs.musicgen_medium``).

48L d_model=1536 24H (MHA kv=24, head_dim 64) d_ff=6144 (GELU) vocab=2048
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub, as in the
reference: inputs are 4-codebook token frames (B, S, 4) (delay pattern
handled upstream); the backbone sums the codebook embeddings and predicts
4 codebook heads, (..., 4, 2048) logits. As in the reference, only the
model functions serve it: no engine takes codebook heads.
"""
from repro_torch.core import MXFP8
from repro_torch.nn import BlockDef, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        d_model=1536, vocab_size=2048,
        pattern=(BlockDef("attn"),), num_groups=48,
        num_heads=24, num_kv_heads=24, head_dim=64,
        d_ff=6144, ffn_kind="gelu",
        num_codebooks=4,
        quant=MXFP8,
        source="arXiv:2306.05284; hf",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, vocab_size=128, num_groups=2,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        quant=MXFP8.replace(block_size=16),
    )

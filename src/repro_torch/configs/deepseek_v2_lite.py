"""deepseek-v2-lite-16b [moe]: MLA (kv_lora 512) + fine-grained MoE (port
of ``repro.configs.deepseek_v2_lite``).

27L d_model=2048 16H d_ff_expert=1408 vocab=102400, 64 routed experts top-6
+ 2 shared [arXiv:2405.04434; hf]. The first layer has a dense FFN
(d_ff 10944), the other 26 the MoE: one prologue block, then the pattern
26 times. Served through ``FixedSlotEngine`` alone (the latent cache has
no page layout, as in the reference).
"""
from repro_torch.core import MXFP8
from repro_torch.nn import BlockDef, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        d_model=2048, vocab_size=102400,
        prologue=(BlockDef("mla", ffn="dense"),),
        pattern=(BlockDef("mla", ffn="moe"),),
        num_groups=26,
        num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=10944,  # the dense first layer
        num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408,
        kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        quant=MXFP8,
        source="arXiv:2405.04434; hf",
        sub_quadratic=False,  # MLA is full attention over latents
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, vocab_size=512, num_groups=2,
        num_heads=4, d_ff=128,
        num_experts=4, top_k=2, num_shared=1, d_ff_expert=64,
        kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        quant=MXFP8.replace(block_size=16),
    )

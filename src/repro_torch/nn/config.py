"""Model configuration schema (port of ``repro.nn.config``).

Only the fields the ported paths read are carried over: attention and
multi-head latent attention (MLA, deepseek-v2-lite) blocks, the recurrent
mixers (RG-LRU for recurrentgemma, SSD for mamba2, with the reference's
defaults), gemma2's embedding scale, logit softcap and sandwich
post-norms, the MoE channel mixer (mixtral's and deepseek's
``ffn="moe"`` blocks), mixer-only blocks (mamba2's ``ffn="none"``),
musicgen's parallel codebook heads (``num_codebooks``) and training's
``remat``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import QuantConfig


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One decoder block: a sequence mixer + a channel mixer."""

    mixer: str  # "attn" | "mla" | "rglru" | "ssd"
    window: Optional[int] = None  # sliding window for attn mixers
    ffn: str = "dense"  # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    vocab_size: int
    pattern: Tuple[BlockDef, ...]
    num_groups: int
    prologue: Tuple[BlockDef, ...] = ()
    epilogue: Tuple[BlockDef, ...] = ()
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    query_chunk: int = 1024
    d_ff: int = 0
    ffn_kind: str = "swiglu"
    # moe
    num_experts: int = 0
    top_k: int = 0
    num_shared: int = 0
    d_ff_expert: int = 0
    aux_loss_weight: float = 0.01
    moe_dispatch: str = "dense"  # "dense" | "sorted" (grouped products)
    # mla
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # rglru
    rnn_width: int = 0
    conv_width: int = 4
    # ssd
    d_inner: int = 0
    headdim: int = 64
    d_state: int = 128
    ngroups: int = 1
    ssd_chunk: int = 256
    tied_embeddings: bool = True
    scale_embeds_by_sqrt_dim: bool = False
    logit_softcap: Optional[float] = None
    num_codebooks: int = 1  # musicgen: parallel codebook heads
    post_norms: bool = False  # gemma2 sandwich norms
    norm_eps: float = 1e-6
    quant: QuantConfig = QuantConfig()
    compute_dtype: torch.dtype = torch.bfloat16
    # training: "full" recomputes each layer group's forward in the
    # backward (torch.utils.checkpoint), "none" keeps its activations
    remat: str = "full"
    # paged serving: full-length (non-ring) prefill caches, so a prompt's
    # cache reshapes 1:1 into its pages (window masking still applies)
    serve_full_cache: bool = False
    # the split step's paged attention: "einsum" (the gather oracle, the
    # reference's default here) or "fused" (the MX page-walk kernels); the
    # serve engine sets it from ServeConfig.decode_kernel
    decode_kernel: str = "einsum"
    source: str = ""
    sub_quadratic: bool = False  # eligible for long_500k

    @property
    def num_layers(self) -> int:
        return (len(self.prologue) + self.num_groups * len(self.pattern)
                + len(self.epilogue))

    def all_blocks(self) -> Tuple[BlockDef, ...]:
        return (*self.prologue, *(self.pattern * self.num_groups),
                *self.epilogue)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

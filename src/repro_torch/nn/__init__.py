"""The model zoo's layers: attention and multi-head latent attention
mixers, dense and MoE channel mixers."""
from .config import BlockDef, ModelConfig

__all__ = ["BlockDef", "ModelConfig"]

"""Attention-only model zoo layers for serving."""
from .config import BlockDef, ModelConfig

__all__ = ["BlockDef", "ModelConfig"]

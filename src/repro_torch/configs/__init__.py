"""Architecture registry (port of ``repro.configs``): the reference's ten
configs: attention, MLA and the recurrent mixers (RG-LRU, SSD) with
dense, MoE or no channel mixers, llava's embeddings input and musicgen's
codebook heads. ``get_config(name)`` is the full ModelConfig,
``get_reduced(name)`` a CPU-sized config of the same family;
``--arch <id>`` in the launcher resolves through :data:`ARCHS`."""
from __future__ import annotations

import importlib

ARCHS = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "gemma2-2b": "gemma2_2b",
    "gemma2-9b": "gemma2_9b",
    "phi4-mini-3.8b": "phi4_mini",
    "granite-8b": "granite_8b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-780m": "mamba2_780m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "musicgen-medium": "musicgen_medium",
}

from .shapes import SHAPES, ShapeSpec, shape_applicable  # noqa: E402


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")


def get_config(name: str):
    return _module(name).config()


def get_reduced(name: str):
    return _module(name).reduced()


def list_archs():
    return sorted(ARCHS)

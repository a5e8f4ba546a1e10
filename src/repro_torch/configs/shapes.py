"""Assigned input shapes (port of ``repro.configs.shapes``): seq_len x
global_batch.

``decode_*`` / ``long_*`` are one new token against a KV cache of
seq_len; ``train_*`` a training step; ``prefill_*`` prompt processing.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch_cfg, shape: ShapeSpec) -> bool:
    """long_500k requires sub-quadratic attention (assignment rule)."""
    if shape.name == "long_500k":
        return arch_cfg.sub_quadratic
    return True

"""Shared building blocks (port of ``repro.nn.common``).

Parameters are plain nested dicts of tensors. Every init takes an explicit
``torch.Generator`` and ``device``; the JAX package's ``jax.random`` keys
give other numbers from the same seed, so parity tests carry weights over
with ``model.params_from_jax`` instead of re-initialising.
"""
from __future__ import annotations

import math

import torch

# normal-CDF bounds of the reference's truncated_normal(-2, 2)
_TN_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_TN_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          device) -> torch.Tensor:
    """Truncated-normal (|z| <= 2) f32 init with fan-in scaling."""
    stddev = scale / math.sqrt(max(shape[0], 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(2.0 * _TN_LO - 1.0, 2.0 * _TN_HI - 1.0, generator=gen)
    return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(stddev)


def exact_cuda_products(device) -> None:
    """On a card, turn off the two cuBLAS switches that move the bf16
    rounding points of the dense products (``nn.linear._dot_rounded``,
    the tied head) and the f32 attention sums away from the reference's:
    the bf16 reduction in reduced precision, and TF32."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
        torch.backends.cuda.matmul.allow_tf32 = False


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round ``x`` to ``dtype``. PyTorch runs eagerly and every op rounds
    its result to its output dtype, so the reference's
    ``reduce_precision`` guard against elided roundings is a plain
    cast here."""
    return x.to(dtype)

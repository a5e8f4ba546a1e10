"""RMSNorm with the gemma-style (1 + w) scale (port of ``repro.nn.norms``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import host_math

#: XLA:CPU's row sum: windows of this many consecutive elements, each
#: summed in order, level after level (4096 -> 128 -> 4 -> 1)
WINDOW = 32


def rmsnorm_init(dim: int, device) -> dict:
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def window_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as the jitted reference's compiled HLO does:
    reduce-windows of WINDOW consecutive elements, each summed left to
    right, until one value is left. A level whose length is not a multiple
    of WINDOW is padded with zeros split evenly around it, the smaller
    half first (2304 -> 72 -> pad 12 + 12 -> 3 -> 1), as XLA pads it."""
    while v.shape[-1] > 1:
        n = v.shape[-1]
        pad = -n % WINDOW
        if pad:
            lo = pad // 2
            v = torch.nn.functional.pad(v, (lo, pad - lo))
        v = v.reshape(*v.shape[:-1], -1, WINDOW)
        acc = v[..., 0]
        for i in range(1, WINDOW):
            acc = acc + v[..., i]
        v = acc
    return v[..., 0]


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6,
                  dtype=None) -> torch.Tensor:
    """RMSNorm in f32 with weight ``1 + scale``, result in ``dtype``
    (default: ``x``'s dtype).

    On CPU tensors the variance and its rsqrt are the jitted reference's
    bits: :func:`window_sum` of ``x * x``, then XLA:CPU's ``rsqrt`` of
    ``fma(sum, f32(1 / width), eps)`` (XLA folds ``jnp.mean``'s divide
    into that multiply and contracts it with the add;
    ``host_math.rsqrt``, x86 hosts only, raises elsewhere).
    On the card one device reduction (``torch.mean``) and ``torch.rsqrt``
    keep the step free of host round trips; ``chip_smoke.py`` counts the
    bf16 outputs where the two paths part."""
    x32 = x.to(torch.float32)
    if x32.device.type == "cpu":
        recip = np.float32(1.0) / np.float32(x32.shape[-1])
        r = host_math.rsqrt(window_sum(x32 * x32)[..., None], float(recip),
                            eps)
    else:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        r = torch.rsqrt(var + eps)
    norm = x32 * r
    return (norm * (1.0 + params["scale"].to(torch.float32))).to(
        dtype or x.dtype)

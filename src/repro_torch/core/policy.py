"""Quantization policy: the MX config threaded through every layer.

Port of ``repro.core.policy``. ``act_fmt``, ``mode``, ``acc_dtype`` and the
training switches of the reference are left out: the port serves with
f32 accumulation and weight-only MX (``quantize_acts=False``).
"""
from __future__ import annotations

import dataclasses

@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """MX quantization policy for a model.

    Attributes:
      enabled: master switch; False means wide (bf16) everywhere.
      fmt: element format for weights and the KV cache.
      block_size: software-defined MX block size k.
      quantize_acts: quantize activations entering matmuls (not ported:
        the serving path is weight-only).
      quantize_kv_cache: store the serving KV cache in MX format.
    """

    enabled: bool = True
    fmt: str = "fp8_e4m3"
    block_size: int = 32
    quantize_acts: bool = True
    quantize_kv_cache: bool = False

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


MXFP8 = QuantConfig(fmt="fp8_e4m3")

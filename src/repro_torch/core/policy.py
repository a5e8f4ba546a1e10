"""Quantization policy: the MX config threaded through every layer.

Port of ``repro.core.policy``. The reference's ``mx_weight_gather`` (the
FSDP all-gather of MX bytes) belongs to the mesh rules and waits for
ROADMAP A7.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """MX quantization policy for a model.

    Attributes:
      enabled: master switch; False means wide (bf16) everywhere.
      fmt: element format for weights and the KV cache ("fp8_e4m3" |
        "fp8_e5m2" | "fp6_e3m2" | "fp6_e2m3" | "fp4_e2m1").
      act_fmt: element format for activations (defaults to ``fmt``).
      block_size: software-defined MX block size k.
      quantize_acts: quantize activations entering matmuls (MX x MX) or
        keep them wide (weight-only).
      mode: execution mode of ``core.dot.mx_dot`` ("emulated" | "fused" |
        "pallas"; "pallas" names the hand-written-kernel tier).
      acc_dtype: accumulator precision (f32 per the spec, bf16 compact).
      quantize_kv_cache: store the serving KV cache in MX format.
      quantize_grads: fake-quantize the gradients to MXFP8-E5M2 blocks
        of 32 before the optimizer (training).
    """

    enabled: bool = True
    fmt: str = "fp8_e4m3"
    act_fmt: Optional[str] = None
    block_size: int = 32
    quantize_acts: bool = True
    mode: str = "fused"
    acc_dtype: torch.dtype = torch.float32
    quantize_kv_cache: bool = False
    quantize_grads: bool = False

    @property
    def activation_format(self) -> str:
        return self.act_fmt or self.fmt

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


WIDE = QuantConfig(enabled=False)
MXFP8 = QuantConfig(fmt="fp8_e4m3", act_fmt="fp8_e5m2")
# The matmul kernels take no FP6 operands: the FP6 and FP4 presets keep
# activations at e5m2 and serve mostly as weight/KV-cache policies.
MXFP6 = QuantConfig(fmt="fp6_e3m2", act_fmt="fp8_e5m2")
MXFP4 = QuantConfig(fmt="fp4_e2m1", act_fmt="fp8_e5m2")

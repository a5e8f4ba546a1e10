"""MX numerics: formats, block quantization, policy."""
from .dot import fake_quant
from .mx_tensor import MXTensor
from .policy import MXFP8, QuantConfig
from .quantize import quantize, quantize_value

__all__ = ["MXFP8", "MXTensor", "QuantConfig", "fake_quant", "quantize",
           "quantize_value"]

"""MX numerics: formats, block quantization, policy."""
from .dot import fake_quant, mx_dot, qat_matmul
from .mx_tensor import MXTensor
from .policy import MXFP4, MXFP6, MXFP8, WIDE, QuantConfig
from .quantize import dequantize, quantize, quantize_value

__all__ = ["MXFP4", "MXFP6", "MXFP8", "MXTensor", "QuantConfig", "WIDE",
           "dequantize", "fake_quant", "mx_dot", "qat_matmul", "quantize",
           "quantize_value"]

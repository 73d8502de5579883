"""Block quantization: int8 (a hand-written kernel on CUDA) and int4."""

from .quantize import (dequantize_int4, dequantize_int8, quantize_int4, quantize_int8,
                       quantize_int8_reference)

__all__ = ["dequantize_int4", "dequantize_int8", "quantize_int4", "quantize_int8",
           "quantize_int8_reference"]

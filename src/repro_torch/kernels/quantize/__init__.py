"""Symmetric per-row int8 quantization (the gradient-compression NT): the
CUDA kernels' wrappers, the device-dispatching ops and the plain
versions."""
from .kernel import dequantize_int8_cuda, quantize_int8_cuda  # noqa: F401
from .ops import dequantize, quantize  # noqa: F401
from .ref import dequantize_int8_ref, quantize_int8_ref  # noqa: F401

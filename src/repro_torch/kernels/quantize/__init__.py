from repro_torch.kernels.quantize.ops import (
    dequantize,
    dequantize_leaves,
    dequantize_leaves_plain,
    dequantize_plain,
    quant_blocks,
    quantize,
    quantize_leaves,
    quantize_leaves_plain,
    quantize_plain,
)

__all__ = ["quantize", "quantize_leaves", "dequantize", "dequantize_leaves", "quant_blocks",
           "quantize_plain", "quantize_leaves_plain", "dequantize_plain",
           "dequantize_leaves_plain"]

from repro_torch.kernels.quantize.ops import (
    dequantize,
    dequantize_plain,
    quant_blocks,
    quantize,
    quantize_leaves,
    quantize_leaves_plain,
    quantize_plain,
)

__all__ = ["quantize", "quantize_leaves", "dequantize", "quant_blocks", "quantize_plain",
           "quantize_leaves_plain", "dequantize_plain"]

from repro_torch.kernels.quantize.ops import (
    dequantize,
    dequantize_plain,
    quant_blocks,
    quantize,
    quantize_plain,
)

__all__ = ["quantize", "dequantize", "quant_blocks", "quantize_plain", "dequantize_plain"]

from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_bwd,
    flash_attention_plain,
)

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_backward_plain",
           "flash_attention_bwd", "flash_attention_plain"]

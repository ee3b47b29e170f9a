"""Hand-written CUDA kernels (sm_90a) of the port, one per TPU kernel of
the JAX package:

  quantize, dequantize — per-block absmax int8/int4 (de)quantization
                         (the uplink codec, a round's leaves in one launch
                         of each; csrc/quantize.cu)
  masked_aggregate     — the paper's Eq. 1 masked weighted client average,
                         every leaf of a round in one launch (the
                         aggregators), and the async staleness merge
                         g + mean(x - snapshot), one launch an event;
                         both also through E edge groups, the two-level
                         edge-server sum, and in partial and combine
                         launches when the cohort's lanes are sharded
                         over ranks (csrc/masked_aggregate.cu)
  ssm_scan             — the Mamba-1 selective scan of a prefill
                         (falcon-mamba, jamba; csrc/ssm_scan.cu), and of
                         training's forward, which also keeps the state at
                         every 128-step chunk's start
  flash_attention      — GQA attention of a prefill, causal (the
                         decoders) or not (whisper's encoder and its
                         cross-attention, T != S, at decode too); bf16 on
                         wgmma: csrc/flash_attention_wgmma.cu, float32:
                         csrc/flash_attention.cu; in training also each
                         row's logsumexp

and two that no TPU kernel had, the backwards of training (the JAX package
differentiates jnp code there):

  ssm_scan_bwd         — the selective scan's gradients from the chunk
                         start states (models/ssm_vjp.py's
                         selective_scan; csrc/ssm_scan_bwd.cu)
  flash_attention_bwd  — dQ, dK, dV of flash_attention (FlashAttentionFn);
                         bf16 on wgmma + TMA:
                         csrc/flash_attention_bwd_wgmma.cu, float32:
                         csrc/flash_attention_bwd.cu

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors (``build.py`` compiles the sources with nvcc at first
use). ``launch_counts``/``reset_launch_counts`` read and zero the wrappers'
launch counters, so a run can show that its path went through the kernels;
``add_launch_counts`` adds to them where kernels launch without a wrapper
call: a CUDA-graph replay launches what its capture recorded
(``repro_torch.fl.api.build_chunk_step``).
"""

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.masked_aggregate import (
    masked_aggregate,
    masked_aggregate_combine,
    masked_aggregate_leaves,
    masked_aggregate_partial,
)
from repro_torch.kernels.quantize import dequantize, dequantize_leaves, quantize, quantize_leaves
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd

KERNELS = {
    "quantize": quantize_leaves,
    "dequantize": dequantize_leaves,
    "masked_aggregate": masked_aggregate_leaves,
    "masked_aggregate_partial": masked_aggregate_partial,
    "masked_aggregate_combine": masked_aggregate_combine,
    "ssm_scan": ssm_scan,
    "flash_attention": flash_attention,
    "ssm_scan_bwd": ssm_scan_bwd,
    "flash_attention_bwd": flash_attention_bwd,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (launches per wrapper name) to the counters."""
    for name, n in counts.items():
        KERNELS[name].launches += n


__all__ = ["quantize", "quantize_leaves", "dequantize", "dequantize_leaves", "masked_aggregate",
           "masked_aggregate_leaves", "ssm_scan", "ssm_scan_bwd", "flash_attention",
           "flash_attention_bwd", "KERNELS", "launch_counts",
           "reset_launch_counts", "add_launch_counts"]

"""Hand-written CUDA kernels (sm_90a) of the port, one per TPU kernel of
the JAX package on the ported path:

  quantize, dequantize — per-block absmax int8/int4 (de)quantization
                         (the uplink codec; csrc/quantize.cu)
  masked_aggregate     — the paper's Eq. 1 masked weighted client average
                         (the aggregators; csrc/masked_aggregate.cu)

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors (``build.py`` compiles the sources with nvcc at first
use). ``launch_counts``/``reset_launch_counts`` read and zero the wrappers'
launch counters, so a run can show that its path went through the kernels.
The model zoo's flash_attention and ssm_scan come with ROADMAP.md queue 2
items 3 and 4.
"""

from repro_torch.kernels.masked_aggregate import masked_aggregate
from repro_torch.kernels.quantize import dequantize, quantize

KERNELS = {
    "quantize": quantize,
    "dequantize": dequantize,
    "masked_aggregate": masked_aggregate,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["quantize", "dequantize", "masked_aggregate", "KERNELS",
           "launch_counts", "reset_launch_counts"]

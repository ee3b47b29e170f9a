"""repro_torch — the PyTorch + CUDA port of the ACSP-FL system.

A second package beside the JAX reference (``src/repro/``), laid out like
it (``configs``, ``data``, ``models``, ``core``, ``comm``, ``kernels``,
``fl``). It imports torch and numpy only. Entry points take ``device=`` and
run on the CUDA card unless the caller asks for the CPU; the codec's
quantize/dequantize pair and the aggregators' masked weighted mean run as
hand-written sm_90a CUDA kernels there (``repro_torch.kernels``), and with
``scan_chunk > 1`` a chunk of rounds runs as one CUDA-graph replay.

    from repro_torch.data import make_har_dataset
    from repro_torch.fl import FLConfig, run_federated

    hist = run_federated(make_har_dataset("uci-har"), FLConfig(codec="int8", rounds=5))
"""

__all__ = ["comm", "configs", "core", "data", "fl", "kernels", "models", "random", "weights"]

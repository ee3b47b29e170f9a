"""repro_torch.serve — the decode side of the JAX package's ``repro.serve``:
the continuous-batching loop (``batching``) and the model zoo's
prefill/decode loops (``decode``). The personalized artifact, engine,
``ClassifyProgram`` and serve records (the batcher's ``recorder``) come
with ROADMAP.md queue 1 items 9 and 11.
"""

from repro_torch.serve.batching import (
    ContinuousBatcher,
    LaneProgram,
    ServeRequest,
    ServeResult,
    latency_stats,
)
from repro_torch.serve.decode import DecodeProgram, greedy_decode, token_only_prefill

__all__ = [
    "ServeRequest",
    "ServeResult",
    "LaneProgram",
    "ContinuousBatcher",
    "latency_stats",
    "DecodeProgram",
    "greedy_decode",
    "token_only_prefill",
]

"""repro_torch.serve — personalized inference serving, the port of the JAX
package's ``repro.serve``.

The deployment half of ACSP-FL: training produces a shared global model
plus per-client personalization state (FT picks, PMS/DLD partial-sharing
layers); this package serves them. Four layers:

- ``repro_torch.serve.artifact`` — the **servable artifact**: export a
  trained run's global params + per-client local slabs + share masks from
  ``RoundState`` via ``repro_torch.checkpoint``; every personalization
  mode (none/FT/PMS/DLD) projects onto one per-client ``(C, L)`` share
  mask. ``load_servable`` also reads an artifact the JAX package saved.
- ``repro_torch.serve.engine``   — ``PersonalizedEngine``: cohort-style
  gather of each requested client's local layers into ``(B, ...)`` batch
  lanes + ``compose_model`` per lane, so ONE batched forward serves B
  *different* personalized models, bitwise per lane the unbatched
  per-client forward.
- ``repro_torch.serve.batching`` — continuous-batching request loop: fixed
  lanes, retirement + same-iteration backfill, per-request latency spans
  (queue wait included). ``ClassifyProgram`` drives the engine;
  ``repro_torch.serve.decode`` plugs the model zoo's prefill/decode path
  into the same loop.
- ``repro_torch.serve.record``   — ``ServeRecorder``: RunRecorder-style
  serve records (manifest + requests.jsonl + optional Perfetto trace)
  through ``repro_torch.obs``.

Quickstart (``device="cpu"`` on a machine without a card)::

    art, _ = fit_servable(ds, cfg)            # or export/load a run's state
    save_servable(art, "experiments/srv")     # -> servable.npz + manifest
    eng = PersonalizedEngine(load_servable("experiments/srv"))
    logits = eng.forward([3, 17, 4], x_batch)  # 3 different client models
"""

from repro_torch.serve.artifact import (
    ServableArtifact,
    fit_servable,
    load_servable,
    save_servable,
    servable_from_state,
)
from repro_torch.serve.batching import (
    ClassifyProgram,
    ContinuousBatcher,
    LaneProgram,
    ServeRequest,
    ServeResult,
    latency_stats,
)
from repro_torch.serve.decode import DecodeProgram, greedy_decode, token_only_prefill
from repro_torch.serve.engine import PersonalizedEngine
from repro_torch.serve.record import ServeRecorder

__all__ = [
    "ServableArtifact",
    "servable_from_state",
    "save_servable",
    "load_servable",
    "fit_servable",
    "PersonalizedEngine",
    "ServeRequest",
    "ServeResult",
    "LaneProgram",
    "ClassifyProgram",
    "ContinuousBatcher",
    "latency_stats",
    "DecodeProgram",
    "greedy_decode",
    "token_only_prefill",
    "ServeRecorder",
]

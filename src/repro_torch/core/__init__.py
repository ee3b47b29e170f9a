"""repro_torch.core — the paper's contribution (ACSP-FL) on torch tensors:
selection (Eq. 4-7), layer sharing and DLD (Eq. 9), personalization
(Eq. 8), masked aggregation (Eq. 1) and the communication metrics."""

from repro_torch.core.aggregation import (
    fedavg_aggregate,
    masked_partial_aggregate,
    staleness_weighted_merge,
)
from repro_torch.core.decay import phi_decay
from repro_torch.core.layersharing import (
    cut_model,
    dynamic_layer_definition,
    layer_share_mask,
    num_layers,
)
from repro_torch.core.personalization import compose_model, personalize_ft
from repro_torch.core.selection import (
    ACSPFL,
    DEEV,
    ClientMetrics,
    ClientObservations,
    FedAvgRandom,
    GradImportance,
    Oort,
    OortFair,
    OortWire,
    PowerOfChoice,
    SelectionStrategy,
    get_strategy,
    register_strategy,
)

__all__ = [
    "SelectionStrategy",
    "ClientObservations",
    "ClientMetrics",
    "FedAvgRandom",
    "PowerOfChoice",
    "Oort",
    "OortWire",
    "OortFair",
    "DEEV",
    "ACSPFL",
    "GradImportance",
    "get_strategy",
    "register_strategy",
    "phi_decay",
    "dynamic_layer_definition",
    "layer_share_mask",
    "cut_model",
    "num_layers",
    "personalize_ft",
    "compose_model",
    "fedavg_aggregate",
    "masked_partial_aggregate",
    "staleness_weighted_merge",
]

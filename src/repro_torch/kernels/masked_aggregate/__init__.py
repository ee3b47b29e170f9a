from repro_torch.kernels.masked_aggregate.ops import (
    masked_aggregate,
    masked_aggregate_combine,
    masked_aggregate_combine_plain,
    masked_aggregate_leaves,
    masked_aggregate_leaves_plain,
    masked_aggregate_partial,
    masked_aggregate_partial_plain,
    masked_aggregate_plain,
    partial_layout,
)

__all__ = ["masked_aggregate", "masked_aggregate_combine", "masked_aggregate_combine_plain",
           "masked_aggregate_leaves", "masked_aggregate_leaves_plain", "masked_aggregate_partial",
           "masked_aggregate_partial_plain", "masked_aggregate_plain", "partial_layout"]

from repro_torch.kernels.masked_aggregate.ops import (
    masked_aggregate,
    masked_aggregate_leaves,
    masked_aggregate_leaves_plain,
    masked_aggregate_plain,
)

__all__ = ["masked_aggregate", "masked_aggregate_leaves", "masked_aggregate_leaves_plain",
           "masked_aggregate_plain"]

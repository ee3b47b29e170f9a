"""Federated data of the port: copies of the JAX package's numpy-only
generators, so both packages build bitwise-equal datasets from a seed."""

from repro_torch.data.har import DATASETS, make_har_dataset
from repro_torch.data.synthetic import (
    FederatedDataset,
    ShardedFederatedData,
    make_federated_classification,
    make_sharded_population,
)

__all__ = [
    "FederatedDataset",
    "ShardedFederatedData",
    "make_federated_classification",
    "make_sharded_population",
    "DATASETS",
    "make_har_dataset",
]

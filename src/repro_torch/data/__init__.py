"""Federated data of the port: copies of the JAX package's numpy-only
generators, so both packages build bitwise-equal datasets from a seed."""

from repro_torch.data.har import DATASETS, make_har_dataset
from repro_torch.data.synthetic import FederatedDataset, make_federated_classification

__all__ = [
    "FederatedDataset",
    "make_federated_classification",
    "DATASETS",
    "make_har_dataset",
]

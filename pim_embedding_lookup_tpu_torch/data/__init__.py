"""Data layer: synthetic query/batch generators, the Criteo Kaggle loader
and the host-to-device prefetch."""

from .criteo import CriteoKaggle, find_dataset
from .prefetch import device_prefetch
from .synthetic import QueryGenerator, SyntheticDLRMBatches, random_tables

__all__ = [
    "CriteoKaggle",
    "find_dataset",
    "QueryGenerator",
    "SyntheticDLRMBatches",
    "random_tables",
    "device_prefetch",
]

"""Synthetic data of the port (copies of ``repro.data``): graphs and
recsys click batches."""
from . import synthetic

__all__ = ["synthetic"]

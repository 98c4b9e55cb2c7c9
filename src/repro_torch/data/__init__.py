"""Synthetic graph generators of the port (copies of ``repro.data``)."""
from . import synthetic

__all__ = ["synthetic"]

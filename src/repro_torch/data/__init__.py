"""Data of the port (copies of ``repro.data``): synthetic graphs and
recsys click batches, and the update and mixed read/write streams."""
from . import streams, synthetic

__all__ = ["streams", "synthetic"]

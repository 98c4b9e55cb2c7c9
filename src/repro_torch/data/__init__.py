"""Data of the port (copies of ``repro.data``): synthetic graphs, token
streams and recsys click batches, the GNN batch sampler, and the update and
mixed read/write streams."""
from . import sampler, streams, synthetic

__all__ = ["sampler", "streams", "synthetic"]

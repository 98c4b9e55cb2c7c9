"""Models of the port: the dense LM family (``layers``, ``transformer``)
and the recsys family (``recsys``: xDeepFM)."""
from . import layers, recsys, transformer

__all__ = ["layers", "recsys", "transformer"]

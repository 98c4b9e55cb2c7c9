"""Models of the port: the dense LM family (``layers``, ``transformer``)."""
from . import layers, transformer

__all__ = ["layers", "transformer"]

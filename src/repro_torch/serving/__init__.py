"""LM serving of the port: the batched decode engine."""
from .engine import DecodeEngine, Request

__all__ = ["DecodeEngine", "Request"]

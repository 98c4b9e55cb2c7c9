"""Training support of the port: so far only ``checkpoint`` (save, restore
and ``latest_step``), which the service's snapshots go through."""
from . import checkpoint

__all__ = ["checkpoint"]

"""Training substrate of the port: ``optimizer`` (AdamW, SGD, schedules,
the train step), ``compression`` (int8 with error feedback, the compressed
psum over a ``ShardMesh``), ``checkpoint`` (save, restore, the async
writer, the preemption hook; the service's snapshots go through it too)
and ``loop`` (the fault-tolerant training loop)."""
from . import checkpoint, compression, loop, optimizer

__all__ = ["checkpoint", "compression", "loop", "optimizer"]

"""Replicated truss serving cluster: WAL-shipped read replicas behind a
consistency-aware query router (port of ``repro.cluster``).

The primary keeps the batch-amortized write path of ``repro_torch.service``; read
throughput scales out by tailing its store directory:

* ``Replica`` — snapshot bootstrap + committed-WAL tailing through the same
  fused ``apply_batch`` path, bitwise-equal phi at every generation
  boundary; ``promote()`` is the crash-failover path.
* ``QueryRouter`` / ``Session`` — strong / bounded-staleness /
  read-your-writes read fan-out over the primary and N replicas.
"""
from .replica import Replica
from .router import QueryRouter, Session, query_from_record

__all__ = ["Replica", "QueryRouter", "Session", "query_from_record"]

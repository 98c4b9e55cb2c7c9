"""Online truss query service: WAL-backed store + indexed query engine."""
from .api import (BOUNDED, COMMUNITY, CONSISTENCY_LEVELS, MAX_K, MEMBERS,
                  QUERY_KINDS, READ_YOUR_WRITES, REPRESENTATIVES, STRONG,
                  Overloaded, QueryRequest, QueryResponse, WriteAck,
                  WriteRequest)
from .engine import TrussService
from .store import TrussStore

__all__ = [
    "TrussService", "TrussStore", "QueryRequest", "QueryResponse",
    "WriteRequest", "WriteAck", "Overloaded", "QUERY_KINDS", "MEMBERS",
    "COMMUNITY", "MAX_K", "REPRESENTATIVES", "CONSISTENCY_LEVELS", "STRONG",
    "BOUNDED", "READ_YOUR_WRITES",
]

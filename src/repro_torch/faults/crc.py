"""CRC32C (Castagnoli) — the WAL v2 per-record checksum.

Pure-Python, table-driven, reflected form of the Castagnoli polynomial
0x1EDC6F41 (reflected 0x82F63B78) — the same CRC iSCSI, ext4 metadata and
LevelDB/RocksDB log records use, chosen over CRC32 (zlib) for its better
Hamming distance at short record lengths.  CRC32C detects **every**
single-bit error and every burst error up to 32 bits, which is exactly
the contract the chaos harness asserts: no injected single-bit flip in a
WAL record ever goes unnoticed.

WAL records are tens of bytes, so the ~150 ns/byte pure-Python cost is
noise against the syscall path; bulk artifacts (snapshots) use SHA-256
via :mod:`hashlib` instead (see ``service/store.py``).
"""
from __future__ import annotations


def _build_table() -> list[int]:
    """The 256-entry lookup table for the reflected Castagnoli polynomial."""
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _build_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data``; pass a previous result as ``crc`` to stream.

    Check value: ``crc32c(b"123456789") == 0xE3069283`` (the standard
    Castagnoli test vector, asserted in ``tests/test_chaos.py`` and ``tests/test_torch_chaos.py``).
    """
    table = _TABLE
    c = (crc & 0xFFFFFFFF) ^ 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF

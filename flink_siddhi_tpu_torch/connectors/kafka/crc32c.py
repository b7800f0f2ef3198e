"""CRC-32C (Castagnoli), the checksum of Kafka v2 record batches.

``zlib.crc32`` is CRC-32 (polynomial 0x04C11DB7, the magic-0/1 message
checksum); v2 batches switched to Castagnoli (reflected polynomial
0x82F63B78) and nothing in the stdlib computes it. This is the
classic byte-at-a-time table implementation — slow-path Python, but
record-batch checksums are per *batch*, not per record, so the cost
amortizes across every record in the batch.

Correctness is anchored to the RFC 3720 appendix B.4 known-answer
vectors (32 zero bytes -> 0x8A9136AA, etc.) in
tests/test_connectors_kafka.py.
"""

from __future__ import annotations

_POLY = 0x82F63B78


def _make_table() -> tuple:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_TABLE = _make_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """-> unsigned 32-bit CRC-32C of ``data``; pass a previous return
    value as ``crc`` to continue a running checksum."""
    crc ^= 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF

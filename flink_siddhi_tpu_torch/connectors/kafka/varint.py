"""Zigzag varints — the integer encoding of Kafka's v2 record format.

Every per-record integer in a magic-2 RecordBatch (lengths, offset
deltas, timestamp deltas, header counts) is a protobuf-style varint
with zigzag signed mapping: ``n -> (n << 1) ^ (n >> 63)`` so small
negative numbers (null markers are -1) stay one byte. ``varint`` is
the 32-bit flavor, ``varlong`` the 64-bit one; both reject
encodings that overrun their width rather than silently wrapping.
"""

from __future__ import annotations

from typing import Tuple


class VarintError(ValueError):
    pass


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _zigzag_decode(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _encode_unsigned(u: int, max_bytes: int) -> bytes:
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    if len(out) > max_bytes:
        raise VarintError(f"varint overflow: {len(out)} bytes")
    return bytes(out)


def _decode_unsigned(
    data: bytes, pos: int, max_bytes: int
) -> Tuple[int, int]:
    u = 0
    shift = 0
    for i in range(max_bytes):
        if pos + i >= len(data):
            raise VarintError("truncated varint")
        b = data[pos + i]
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            return u, pos + i + 1
        shift += 7
    raise VarintError(f"varint longer than {max_bytes} bytes")


def encode_varint(n: int) -> bytes:
    """Signed 32-bit zigzag varint (1-5 bytes)."""
    if not -(1 << 31) <= n < (1 << 31):
        raise VarintError(f"varint out of int32 range: {n}")
    return _encode_unsigned(_zigzag_encode(n), 5)


def decode_varint(data: bytes, pos: int = 0) -> Tuple[int, int]:
    """-> (value, new_pos)."""
    u, pos = _decode_unsigned(data, pos, 5)
    return _zigzag_decode(u), pos


def encode_varlong(n: int) -> bytes:
    """Signed 64-bit zigzag varint (1-10 bytes)."""
    if not -(1 << 63) <= n < (1 << 63):
        raise VarintError(f"varlong out of int64 range: {n}")
    return _encode_unsigned(_zigzag_encode(n), 10)


def decode_varlong(data: bytes, pos: int = 0) -> Tuple[int, int]:
    """-> (value, new_pos)."""
    u, pos = _decode_unsigned(data, pos, 10)
    return _zigzag_decode(u), pos

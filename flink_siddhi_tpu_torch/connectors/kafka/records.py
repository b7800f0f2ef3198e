"""Kafka record-set encoding: magic 0/1 message sets and magic 2
record batches, behind one decode entry point.

A Fetch response's record set is a byte blob that may hold any mix of
the two on-disk formats (a topic migrated broker-side keeps old
segments); both start with ``offset:int64 length:int32`` and put the
magic byte at blob offset 16, so ``decode_record_set`` dispatches per
entry:

* magic 0/1 — one CRC32-framed message per record, optional i64
  timestamp (magic 1). Compressed *wrapper* messages are rejected
  loudly with the codec named: the wrapper's value is an inner message
  set and decoding it as an event payload would silently drop every
  record on the topic.
* magic 2 — the RecordBatch format (KIP-98): one 61-byte header
  (base offset, attributes, base/max timestamps, producer fields,
  record count) followed by varint-delta records, the whole record
  section compressed as a unit by the codec in the attributes' low 3
  bits. The batch-level CRC-32C (header-from-attributes + records) is
  validated on EVERY decode — a corrupt batch raises
  ``CorruptBatchError`` rather than skipping records.

Partial trailing entries (Fetch truncates at max_bytes) are dropped,
matching client convention; everything else malformed is an error.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

from .codecs import CODEC_NONE, codec_name, compress, decompress
from .crc32c import crc32c
from .errors import KafkaError
from .varint import (
    decode_varint,
    decode_varlong,
    encode_varint,
    encode_varlong,
)

MAGIC_V0 = 0
MAGIC_V1 = 1
MAGIC_V2 = 2

# attributes bits (magic 2)
_CODEC_MASK = 0x07
_FLAG_TXN = 0x10
_FLAG_CONTROL = 0x20

# control-record marker types (KIP-98): the key of a control record is
# ``version:int16 type:int16``; type 1 commits, type 0 aborts.
CONTROL_ABORT = 0
CONTROL_COMMIT = 1

_NO_TIMESTAMP = -1

# (offset, ts_ms_or_None, key, value)
DecodedRecord = Tuple[int, Optional[int], Optional[bytes], Optional[bytes]]


class CorruptBatchError(KafkaError):
    """A record set failed structural or checksum validation.

    Retryable: corruption observed on the wire is indistinguishable
    from a flaky link — re-fetching the same offsets may produce clean
    bytes (and the fake broker's ``mangle_batch`` faults are exactly
    that shape). Persistent log corruption surfaces as retry
    exhaustion, not as a silent skip."""

    retryable = True


# -- magic 0/1 message sets ------------------------------------------------

def encode_message_set(
    values: Sequence[bytes], magic: int = 1, ts_ms: int = 0
) -> bytes:
    """One CRC32-framed message per value, null keys, no compression."""
    parts: List[bytes] = []
    for v in values:
        body = struct.pack(">bb", magic, 0)  # magic, attributes
        if magic >= 1:
            body += struct.pack(">q", ts_ms)
        body += struct.pack(">i", -1)  # null key
        body += struct.pack(">i", len(v)) + v
        crc = zlib.crc32(body) & 0xFFFFFFFF
        # offset 0: assigned by the broker on produce
        parts.append(struct.pack(">qiI", 0, 4 + len(body), crc) + body)
    return b"".join(parts)


def _decode_legacy_message(data: bytes, pos: int, size: int) -> DecodedRecord:
    """One magic 0/1 entry at ``pos`` (12-byte entry header included)."""
    (offset,) = struct.unpack_from(">q", data, pos)
    body = data[pos + 12 : pos + 12 + size]
    (crc,) = struct.unpack_from(">I", body, 0)
    actual = zlib.crc32(body[4:]) & 0xFFFFFFFF
    if actual != crc:
        raise CorruptBatchError(
            f"message at offset {offset} failed CRC-32 (stored "
            f"0x{crc:08X}, computed 0x{actual:08X})"
        )
    magic, attrs = struct.unpack_from(">bb", body, 4)  # after crc
    codec = attrs & _CODEC_MASK
    if codec:
        raise CorruptBatchError(
            f"magic-{magic} wrapper message compressed with "
            f"{codec_name(codec)!r}: legacy compressed message sets are "
            "not supported — produce with magic 2 record batches "
            "(gzip) or compression.type=none"
        )
    p = 6
    ts: Optional[int] = None
    if magic >= 1:
        (ts,) = struct.unpack_from(">q", body, p)
        p += 8
    (klen,) = struct.unpack_from(">i", body, p)
    p += 4
    key = None if klen < 0 else body[p : p + klen]
    p += max(klen, 0)
    (vlen,) = struct.unpack_from(">i", body, p)
    p += 4
    value = None if vlen < 0 else body[p : p + vlen]
    return offset, ts, key, value


def decode_message_set(data: bytes) -> List[DecodedRecord]:
    """Legacy-only decode (a v0 Produce request's payload); use
    ``decode_record_set`` for fetch responses, which may hold magic 2."""
    out: List[DecodedRecord] = []
    pos, n = 0, len(data)
    while pos + 12 <= n:
        size = struct.unpack_from(">i", data, pos + 8)[0]
        if pos + 12 + size > n:
            break  # partial trailing message
        out.append(_decode_legacy_message(data, pos, size))
        pos += 12 + size
    return out


# -- magic 2 record batches ------------------------------------------------

def _encode_record(
    offset_delta: int,
    ts_delta: int,
    key: Optional[bytes],
    value: Optional[bytes],
    headers: Sequence[Tuple[bytes, Optional[bytes]]] = (),
) -> bytes:
    body = bytearray(b"\x00")  # record attributes: unused
    body += encode_varlong(ts_delta)
    body += encode_varint(offset_delta)
    for blob in (key, value):
        if blob is None:
            body += encode_varint(-1)
        else:
            body += encode_varint(len(blob)) + blob
    body += encode_varint(len(headers))
    for hkey, hval in headers:
        body += encode_varint(len(hkey)) + hkey
        if hval is None:
            body += encode_varint(-1)
        else:
            body += encode_varint(len(hval)) + hval
    return bytes(encode_varint(len(body)) + body)


def encode_record_batch(
    records: Sequence[tuple],
    base_offset: int = 0,
    codec: int = CODEC_NONE,
    producer_id: int = -1,
    producer_epoch: int = -1,
    base_sequence: int = -1,
    transactional: bool = False,
    control: bool = False,
) -> bytes:
    """Encode one RecordBatch.

    ``records``: ``(ts_ms, key, value)`` or ``(ts_ms, key, value,
    headers)`` tuples, assigned offsets ``base_offset + index``. The
    record section is compressed with ``codec`` (codecs.py id); the
    batch header, including the record count, stays uncompressed so
    brokers and clients can account records without inflating.

    ``producer_id``/``producer_epoch``/``base_sequence`` are the
    KIP-98 idempotence fields (``-1`` = non-idempotent, the classic
    path). ``transactional`` sets attributes bit 0x10 (the batch is
    invisible to read-committed consumers until its transaction's
    commit marker lands); ``control`` sets bit 0x20 (the batch holds
    transaction markers, not data).
    """
    if not records:
        raise ValueError("record batch needs at least one record")
    base_ts = int(records[0][0])
    max_ts = base_ts
    encoded = bytearray()
    for i, rec in enumerate(records):
        ts, key, value = int(rec[0]), rec[1], rec[2]
        headers = rec[3] if len(rec) > 3 else ()
        max_ts = max(max_ts, ts)
        encoded += _encode_record(i, ts - base_ts, key, value, headers)
    payload = compress(codec, bytes(encoded))
    attrs = codec & _CODEC_MASK
    if transactional:
        attrs |= _FLAG_TXN
    if control:
        attrs |= _FLAG_CONTROL
    # header from attributes onward is what the CRC covers
    after_crc = (
        struct.pack(
            ">hiqqqhii",
            attrs,
            len(records) - 1,  # lastOffsetDelta
            base_ts,
            max_ts,
            producer_id,
            producer_epoch,
            base_sequence,
            len(records),
        )
        + payload
    )
    crc = crc32c(after_crc)
    body = struct.pack(">iBI", 0, MAGIC_V2, crc) + after_crc
    return struct.pack(">qi", base_offset, len(body)) + body


def encode_control_batch(
    base_offset: int,
    producer_id: int,
    producer_epoch: int,
    commit: bool,
    ts_ms: int = 0,
) -> bytes:
    """One transaction marker (COMMIT or ABORT) as a control batch.

    The marker's key is ``version:int16 type:int16`` (type 1 commit,
    0 abort), its value ``version:int16 coordinator_epoch:int32`` —
    both ignored by this client's decode path (control payloads are
    nulled), but encoded faithfully so the on-wire bytes are real.
    Control batches are transactional and carry the producer's
    id/epoch; their base_sequence is -1 (markers don't consume
    sequence numbers)."""
    marker = CONTROL_COMMIT if commit else CONTROL_ABORT
    key = struct.pack(">hh", 0, marker)
    value = struct.pack(">hi", 0, 0)
    return encode_record_batch(
        [(ts_ms, key, value)],
        base_offset=base_offset,
        producer_id=producer_id,
        producer_epoch=producer_epoch,
        transactional=True,
        control=True,
    )


def decode_batch_meta(data: bytes, pos: int = 0) -> dict:
    """Header fields of the magic-2 batch at ``pos``, without decoding
    (or validating) the record payload — what a broker needs to route
    a produce (producer id/epoch/sequence, transactional bit) and a
    read-committed consumer needs to attribute a batch to its
    transaction. Raises ``CorruptBatchError`` on truncation or wrong
    magic; CRC is NOT checked here (use ``decode_record_batch`` for
    that)."""
    if pos + 61 > len(data):
        raise CorruptBatchError("truncated record batch header")
    base_offset, batch_len = struct.unpack_from(">qi", data, pos)
    _epoch, magic, _crc = struct.unpack_from(">iBI", data, pos + 12)
    if magic != MAGIC_V2:
        raise CorruptBatchError(f"not a v2 batch (magic {magic})")
    (
        attrs,
        last_off_delta,
        _base_ts,
        _max_ts,
        producer_id,
        producer_epoch,
        base_seq,
        n_records,
    ) = struct.unpack_from(">hiqqqhii", data, pos + 21)
    return {
        "base_offset": int(base_offset),
        "length": int(batch_len) + 12,  # whole frame, header included
        "last_offset": int(base_offset) + int(last_off_delta),
        "records": int(n_records),
        "producer_id": int(producer_id),
        "producer_epoch": int(producer_epoch),
        "base_sequence": int(base_seq),
        "transactional": bool(attrs & _FLAG_TXN),
        "control": bool(attrs & _FLAG_CONTROL),
    }


def _decode_record(
    data: bytes, pos: int, base_offset: int, base_ts: int
) -> Tuple[DecodedRecord, int]:
    length, pos = decode_varint(data, pos)
    end = pos + length
    if end > len(data):
        raise CorruptBatchError(
            f"record overruns batch payload ({end} > {len(data)})"
        )
    pos += 1  # record attributes: unused
    ts_delta, pos = decode_varlong(data, pos)
    off_delta, pos = decode_varint(data, pos)
    klen, pos = decode_varint(data, pos)
    key = None if klen < 0 else data[pos : pos + klen]
    pos += max(klen, 0)
    vlen, pos = decode_varint(data, pos)
    value = None if vlen < 0 else data[pos : pos + vlen]
    pos += max(vlen, 0)
    n_headers, pos = decode_varint(data, pos)
    for _ in range(n_headers):
        hklen, pos = decode_varint(data, pos)
        pos += max(hklen, 0)
        hvlen, pos = decode_varint(data, pos)
        pos += max(hvlen, 0)
    if pos != end:
        raise CorruptBatchError(
            f"record length field disagrees with contents "
            f"({pos} != {end})"
        )
    ts = None if base_ts == _NO_TIMESTAMP else base_ts + ts_delta
    return (base_offset + off_delta, ts, key, value), end


def decode_record_batch(
    data: bytes, pos: int = 0
) -> Tuple[List[DecodedRecord], int]:
    """Decode ONE magic-2 batch at ``pos`` -> (records, new_pos).
    CRC-32C is validated before anything else is trusted; control
    batches (transaction markers) yield no records but advance."""
    base_offset, batch_len = struct.unpack_from(">qi", data, pos)
    end = pos + 12 + batch_len
    if end > len(data):
        raise CorruptBatchError("truncated record batch")
    _epoch, magic, crc = struct.unpack_from(">iBI", data, pos + 12)
    if magic != MAGIC_V2:
        raise CorruptBatchError(f"not a v2 batch (magic {magic})")
    crc_region = data[pos + 21 : end]
    actual = crc32c(crc_region)
    if actual != crc:
        raise CorruptBatchError(
            f"record batch at offset {base_offset} failed CRC-32C "
            f"(stored 0x{crc:08X}, computed 0x{actual:08X}): refusing "
            "to decode a corrupt batch"
        )
    (
        attrs,
        last_off_delta,
        base_ts,
        _max_ts,
        _producer_id,
        _producer_epoch,
        _base_seq,
        n_records,
    ) = struct.unpack_from(">hiqqqhii", data, pos + 21)
    payload = decompress(attrs & _CODEC_MASK, data[pos + 61 : end])
    records: List[DecodedRecord] = []
    p = 0
    for _ in range(n_records):
        rec, p = _decode_record(payload, p, base_offset, base_ts)
        records.append(rec)
    if p != len(payload):
        raise CorruptBatchError(
            f"batch at offset {base_offset}: {len(payload) - p} "
            f"trailing bytes after {n_records} records"
        )
    if records and records[-1][0] - base_offset != last_off_delta:
        raise CorruptBatchError(
            f"batch at offset {base_offset}: lastOffsetDelta "
            f"{last_off_delta} != final record delta "
            f"{records[-1][0] - base_offset}"
        )
    if attrs & _FLAG_CONTROL:
        # transaction markers, not data: keep the offsets (consumers
        # must advance past the batch, or they wedge on its offset
        # range forever) but null the payloads so nothing downstream
        # mistakes a marker for an event
        records = [(off, ts, None, None) for off, ts, _k, _v in records]
    return records, end


# -- unified fetch-response decode ----------------------------------------

def decode_record_set(data: bytes) -> List[DecodedRecord]:
    """Decode a fetch response's record set: any mix of magic 0/1
    message-set entries and magic 2 record batches. A partial trailing
    entry is dropped; corruption and unknown magic raise."""
    out: List[DecodedRecord] = []
    pos, n = 0, len(data)
    while pos + 17 <= n:  # 12-byte entry header + at least the magic
        size = struct.unpack_from(">i", data, pos + 8)[0]
        if pos + 12 + size > n:
            break  # partial trailing entry (Fetch max_bytes cut)
        magic = data[pos + 16]
        if magic == MAGIC_V2:
            records, pos = decode_record_batch(data, pos)
            out.extend(records)
        elif magic in (MAGIC_V0, MAGIC_V1):
            out.append(_decode_legacy_message(data, pos, size))
            pos += 12 + size
        else:
            raise CorruptBatchError(
                f"unknown record format magic {magic} at record-set "
                f"byte {pos}: this client speaks magic 0, 1 and 2"
            )
    return out

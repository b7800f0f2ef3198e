"""connectors/kafka wire-format layer: varints, CRC-32C known-answer
vectors, v2 record batches (codecs, corruption, unknown magic), and
API-version negotiation against both fake-broker dialects.

Everything here is tier-1 ("not slow"): bounded batch sizes, no
sleeps — the fake broker answers in-process.
"""

import gzip
import struct

import pytest

from flink_siddhi_tpu_torch.connectors.kafka.codecs import (
    CODEC_GZIP,
    CODEC_LZ4,
    CODEC_NONE,
    CODEC_SNAPPY,
    CODEC_ZSTD,
    UnsupportedCodecError,
    codec_id,
    compress,
    decompress,
)
from flink_siddhi_tpu_torch.connectors.kafka.crc32c import crc32c
from flink_siddhi_tpu_torch.connectors.kafka.records import (
    CorruptBatchError,
    decode_message_set,
    decode_record_batch,
    decode_record_set,
    encode_message_set,
    encode_record_batch,
)
from flink_siddhi_tpu_torch.connectors.kafka.errors import (
    BrokerErrorResponse,
    ProducerFencedError,
    is_retryable,
)
from flink_siddhi_tpu_torch.connectors.kafka.protocol import (
    API_END_TXN,
    API_FETCH,
    API_INIT_PRODUCER_ID,
    API_PRODUCE,
    ProtocolError,
    Reader,
    Writer,
    negotiate,
)
from flink_siddhi_tpu_torch.connectors.kafka.txn import (
    decode_add_partitions_response,
    decode_end_txn_response,
    decode_init_producer_id_response,
)
from flink_siddhi_tpu_torch.connectors.kafka.varint import (
    VarintError,
    decode_varint,
    decode_varlong,
    encode_varint,
    encode_varlong,
)
from flink_siddhi_tpu_torch.runtime.kafka import KafkaClient, KafkaError
from tests.torch_fake_kafka import FakeBroker, read_topic


# -- varints ---------------------------------------------------------------

def test_varint_zigzag_known_answers():
    # protobuf/Kafka zigzag: 0,-1,1,-2,2 -> 0,1,2,3,4
    assert encode_varint(0) == b"\x00"
    assert encode_varint(-1) == b"\x01"
    assert encode_varint(1) == b"\x02"
    assert encode_varint(-2) == b"\x03"
    assert encode_varint(2) == b"\x04"
    assert encode_varint(150) == b"\xac\x02"  # zigzag 300 = 0b10_0101100
    assert encode_varint(2**31 - 1) == b"\xfe\xff\xff\xff\x0f"
    assert encode_varint(-(2**31)) == b"\xff\xff\xff\xff\x0f"


@pytest.mark.parametrize(
    "n", [0, 1, -1, 63, -64, 300, -301, 2**31 - 1, -(2**31)]
)
def test_varint_roundtrip(n):
    v, pos = decode_varint(encode_varint(n))
    assert (v, pos) == (n, len(encode_varint(n)))


@pytest.mark.parametrize(
    "n", [0, -1, 2**31, -(2**31) - 1, 2**63 - 1, -(2**63), 10**15]
)
def test_varlong_roundtrip(n):
    v, pos = decode_varlong(encode_varlong(n))
    assert (v, pos) == (n, len(encode_varlong(n)))


def test_varint_errors():
    with pytest.raises(VarintError):
        encode_varint(2**31)  # int32 overflow
    with pytest.raises(VarintError):
        decode_varint(b"\x80\x80")  # truncated continuation
    with pytest.raises(VarintError):
        decode_varint(b"\x80\x80\x80\x80\x80\x80")  # > 5 bytes


# -- CRC-32C (RFC 3720 appendix B.4 known answers) -------------------------

_ISCSI_READ_PDU = bytes(
    [0x01, 0xC0, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x14, 0x00, 0x00, 0x00, 0x00, 0x00, 0x04, 0x00,
     0x00, 0x00, 0x00, 0x14, 0x00, 0x00, 0x00, 0x18,
     0x28, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x02, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00]
)


@pytest.mark.parametrize(
    "data,expect",
    [
        (bytes(32), 0x8A9136AA),  # 32 zeros
        (b"\xff" * 32, 0x62A8AB43),  # 32 ones
        (bytes(range(32)), 0x46DD794E),  # ascending
        (bytes(range(31, -1, -1)), 0x113FDB5C),  # descending
        (_ISCSI_READ_PDU, 0xD9963A56),  # SCSI Read(10) command PDU
        (b"123456789", 0xE3069283),  # classic CRC check string
    ],
)
def test_crc32c_known_answers(data, expect):
    assert crc32c(data) == expect


def test_crc32c_incremental():
    data = bytes(range(256)) * 3
    split = crc32c(data[100:], crc32c(data[:100]))
    assert split == crc32c(data)


# -- codecs ----------------------------------------------------------------

def test_codec_gzip_roundtrip_and_determinism():
    payload = b"x" * 1000 + bytes(range(256))
    blob = compress(CODEC_GZIP, payload)
    assert decompress(CODEC_GZIP, blob) == payload
    assert gzip.decompress(blob) == payload  # honest gzip framing
    assert blob == compress(CODEC_GZIP, payload)  # mtime pinned


@pytest.mark.parametrize(
    "codec,name",
    [(CODEC_SNAPPY, "snappy"), (CODEC_LZ4, "lz4"), (CODEC_ZSTD, "zstd")],
)
def test_codec_rejections_name_the_codec(codec, name):
    with pytest.raises(UnsupportedCodecError, match=name):
        compress(codec, b"data")
    with pytest.raises(UnsupportedCodecError, match=name):
        decompress(codec, b"data")
    assert codec_id(name) == codec


# -- v2 record batches -----------------------------------------------------

def _entries(n, base_ts=1000):
    return [
        (base_ts + i, None if i % 2 else b"k%d" % i, b"value-%d" % i)
        for i in range(n)
    ]


@pytest.mark.parametrize("codec", [CODEC_NONE, CODEC_GZIP])
def test_record_batch_roundtrip(codec):
    entries = _entries(17)
    batch = encode_record_batch(entries, base_offset=42, codec=codec)
    records, end = decode_record_batch(batch)
    assert end == len(batch)
    assert [r[0] for r in records] == list(range(42, 42 + 17))
    assert [r[1] for r in records] == [ts for ts, _, _ in entries]
    assert [r[2] for r in records] == [k for _, k, _ in entries]
    assert [r[3] for r in records] == [v for _, _, v in entries]


def test_record_batch_headers_roundtrip():
    entries = [(5, b"k", b"v", [(b"hk", b"hv"), (b"null", None)])]
    records, _ = decode_record_batch(encode_record_batch(entries))
    assert records == [(0, 5, b"k", b"v")]  # headers parsed, not kept


def test_record_batch_crc_corruption_is_loud():
    batch = bytearray(encode_record_batch(_entries(5), base_offset=9))
    batch[len(batch) // 2] ^= 0x40  # flip one bit mid-records
    with pytest.raises(CorruptBatchError, match="CRC-32C"):
        decode_record_batch(bytes(batch))
    # and the batch's identity (base offset) is in the message
    with pytest.raises(CorruptBatchError, match="offset 9"):
        decode_record_batch(bytes(batch))


def _reflag_codec(batch: bytes, codec: int) -> bytes:
    """Flip a valid batch's attributes to claim ``codec``, recomputing
    the CRC so the codec check (not the CRC check) fires."""
    b = bytearray(batch)
    attrs = struct.unpack_from(">h", b, 21)[0]
    struct.pack_into(">h", b, 21, (attrs & ~0x07) | codec)
    struct.pack_into(">I", b, 17, crc32c(bytes(b[21:])))
    return bytes(b)


@pytest.mark.parametrize(
    "codec,name",
    [(CODEC_SNAPPY, "snappy"), (CODEC_LZ4, "lz4"), (CODEC_ZSTD, "zstd")],
)
def test_foreign_codec_batch_rejected_by_name(codec, name):
    batch = _reflag_codec(encode_record_batch(_entries(3)), codec)
    with pytest.raises(UnsupportedCodecError, match=name):
        decode_record_set(batch)


def test_control_batch_advances_offsets_without_data():
    """A control batch (transaction marker) must not wedge consumers:
    its records come back with null payloads but REAL offsets, so the
    fetch position can advance past the batch."""
    batch = bytearray(encode_record_batch(_entries(3), base_offset=10))
    attrs = struct.unpack_from(">h", batch, 21)[0]
    struct.pack_into(">h", batch, 21, attrs | 0x20)  # isControlBatch
    struct.pack_into(">I", batch, 17, crc32c(bytes(batch[21:])))
    records = decode_record_set(bytes(batch))
    assert [(r[0], r[2], r[3]) for r in records] == [
        (10, None, None), (11, None, None), (12, None, None),
    ]


def test_unknown_magic_rejected_by_value():
    batch = bytearray(encode_record_batch(_entries(3)))
    batch[16] = 3  # future magic
    with pytest.raises(CorruptBatchError, match="magic 3"):
        decode_record_set(bytes(batch))


def test_record_set_mixed_formats_and_partial_tail():
    legacy = encode_message_set([b"old-0", b"old-1"])
    # stamp real offsets into the two legacy entries
    l0_len = 12 + struct.unpack_from(">i", legacy, 8)[0]
    legacy = (
        struct.pack(">q", 0) + legacy[8:l0_len]
        + struct.pack(">q", 1) + legacy[l0_len + 8:]
    )
    v2 = encode_record_batch(
        [(7, None, b"new-0"), (8, None, b"new-1")],
        base_offset=2, codec=CODEC_GZIP,
    )
    blob = legacy + v2
    records = decode_record_set(blob + v2[: len(v2) - 5])  # partial tail
    assert [(r[0], r[3]) for r in records] == [
        (0, b"old-0"), (1, b"old-1"), (2, b"new-0"), (3, b"new-1"),
    ]


def test_legacy_compressed_wrapper_rejected_by_name():
    mset = bytearray(encode_message_set([b"inner"]))
    mset[17] |= CODEC_GZIP  # wrapper attributes: gzip
    # re-frame the CRC so the codec rejection (the real guard) fires
    import zlib

    struct.pack_into(
        ">I", mset, 12, zlib.crc32(bytes(mset[16:])) & 0xFFFFFFFF
    )
    with pytest.raises(CorruptBatchError, match="gzip"):
        decode_message_set(bytes(mset))


def test_legacy_crc_corruption_is_loud():
    mset = bytearray(encode_message_set([b"payload"]))
    mset[-1] ^= 0x01
    with pytest.raises(CorruptBatchError, match="CRC-32"):
        decode_message_set(bytes(mset))


# -- version negotiation ---------------------------------------------------

def test_negotiate_intersects_and_falls_back():
    picks = negotiate({API_PRODUCE: (0, 5), API_FETCH: (0, 6)})
    assert picks[API_PRODUCE] == 3  # newest implemented, not newest offered
    assert picks[API_FETCH] == 4
    assert negotiate(None) == {api: 0 for api in negotiate(None)}
    # broker supports only a window above ours: loud, not silent v0
    with pytest.raises(ProtocolError, match="no overlap"):
        negotiate({API_PRODUCE: (5, 7)})


def test_client_negotiates_modern_dialect():
    broker = FakeBroker()
    try:
        client = KafkaClient(broker.host, broker.port)
        picks = client.api_versions()
        assert picks[API_PRODUCE] == 3
        assert picks[API_FETCH] == 4
        client.close()
    finally:
        broker.close()


def test_transient_connect_failure_does_not_pin_v0():
    """Only an established-then-slammed connection means 'pre-0.10
    broker'. A connection REFUSED during negotiation must propagate
    and leave the dialect undecided, not silently pin v0 forever."""
    import socket as _socket

    probe = _socket.create_server(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()  # nothing listens here now
    client = KafkaClient("127.0.0.1", dead_port, timeout_s=2.0)
    with pytest.raises(KafkaError, match="io error"):
        client.api_versions()
    assert client.negotiated is None  # undecided, will renegotiate
    client.close()


def test_client_falls_back_to_v0_for_legacy_broker():
    broker = FakeBroker(legacy=True)
    try:
        broker.create_topic("t")
        client = KafkaClient(broker.host, broker.port)
        assert client.api_versions()[API_FETCH] == 0
        # and the v0 dialect actually works end to end
        client.produce("t", 0, [b"a", b"b"])
        hw, records, _ = client.fetch("t", {0: 0})[0]
        assert hw == 2
        assert [r[3] for r in records] == [b"a", b"b"]
        with pytest.raises(KafkaError, match="Produce >= 3"):
            client.produce("t", 0, [b"c"], compression="gzip")
        client.close()
    finally:
        broker.close()


# -- client <-> fake broker over v2+gzip -----------------------------------

def test_produce_fetch_v2_gzip_roundtrip():
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        client = KafkaClient(broker.host, broker.port)
        values = [b"ev-%03d" % i for i in range(50)]
        base = client.produce("t", 0, values, compression="gzip", ts_ms=77)
        assert base == 0
        # broker stored decoded records (inflated server-side)
        assert [v for _, v in broker.logs[("t", 0)]] == values
        hw, records, _ = client.fetch("t", {0: 0})[0]
        assert hw == 50
        assert [r[3] for r in records] == values
        assert all(r[1] == 77 for r in records)
        client.close()
    finally:
        broker.close()


def test_fetch_mid_batch_returns_whole_batch():
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        broker.append("t", 0, [b"r%d" % i for i in range(20)])
        client = KafkaClient(broker.host, broker.port)
        _, records, _ = client.fetch("t", {0: 13})[0]
        # v2 semantics: the batch containing offset 13 comes back whole
        assert [r[0] for r in records] == list(range(20))
        client.close()
    finally:
        broker.close()


def test_corrupt_batch_on_the_wire_rejected_not_skipped():
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        broker.append("t", 0, [b"a", b"b", b"c"])

        def flip(batch: bytes) -> bytes:
            b = bytearray(batch)
            b[-2] ^= 0x10
            return bytes(b)

        broker.mangle_batch = flip
        client = KafkaClient(broker.host, broker.port)
        with pytest.raises(CorruptBatchError, match="CRC-32C"):
            client.fetch("t", {0: 0})
        client.close()
    finally:
        broker.close()


def test_broker_rejects_corrupt_produced_batch():
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        client = KafkaClient(broker.host, broker.port)
        good = encode_record_batch([(0, None, b"x")])
        bad = bytearray(good)
        bad[-1] ^= 0x01
        # bypass client-side encode: ship the corrupt bytes verbatim
        from flink_siddhi_tpu_torch.connectors.kafka.protocol import Writer

        w = Writer()
        w.string(None).i16(1).i32(1000).i32(1).string("t").i32(1)
        w.i32(0).bytes_(bytes(bad))
        with pytest.raises(KafkaError, match="error 2"):
            client.api_versions()  # pin v3 produce
            r = client._call(API_PRODUCE, 3, w.done())
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    pid, err, off = r.i32(), r.i16(), r.i64()
                    r.i64()
                    if err:
                        raise KafkaError(f"Produce t/{pid}: error {err}")
        assert broker.logs[("t", 0)] == []  # nothing appended
        client.close()
    finally:
        broker.close()

# -- KIP-98 transactions: codecs, coordinator, fencing, visibility ----------

def test_txn_response_codecs_and_error_mapping():
    """Pure wire codecs: happy-path decode plus the error taxonomy —
    47 surfaces as ProducerFencedError (fatal), 51 stays retryable
    (CONCURRENT_TRANSACTIONS), 48 is the resume-commit signal."""
    r = Reader(Writer().i32(0).i16(0).i64(900).i16(7).done())
    assert decode_init_producer_id_response(r) == (900, 7)
    r = Reader(Writer().i32(0).i16(47).i64(-1).i16(-1).done())
    with pytest.raises(ProducerFencedError) as ei:
        decode_init_producer_id_response(r)
    assert ei.value.code == 47 and not is_retryable(ei.value)
    # AddPartitions: the first per-partition error surfaces, located
    w = Writer().i32(0).i32(1).string("t").i32(2)
    w.i32(0).i16(0).i32(1).i16(51)
    with pytest.raises(BrokerErrorResponse, match=r"t\[1\]") as ei:
        decode_add_partitions_response(Reader(w.done()))
    assert ei.value.code == 51 and is_retryable(ei.value)
    with pytest.raises(BrokerErrorResponse) as ei:
        decode_end_txn_response(Reader(Writer().i32(0).i16(48).done()))
    assert ei.value.code == 48 and not is_retryable(ei.value)


def test_init_producer_id_fencing_matrix():
    """Re-running InitProducerId on one transactional id keeps the
    producer id but bumps the epoch; every transactional api then
    refuses the older epoch with 47 (ProducerFencedError, fatal)."""
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        client = KafkaClient(broker.host, broker.port)
        pid, e0 = client.init_producer_id("tx-a")
        pid2, e1 = client.init_producer_id("tx-a")
        assert pid2 == pid and e1 == e0 + 1
        other, oe = client.init_producer_id("tx-b")
        assert other != pid and oe == 0  # distinct id, fresh mapping
        with pytest.raises(ProducerFencedError):
            client.add_partitions_to_txn("tx-a", pid, e0, [("t", 0)])
        client.add_partitions_to_txn("tx-a", pid, e1, [("t", 0)])
        with pytest.raises(ProducerFencedError):
            client.produce(
                "t", 0, [b"zombie"], transactional_id="tx-a",
                producer_id=pid, producer_epoch=e0,
                base_sequence=0, transactional=True,
            )
        with pytest.raises(ProducerFencedError):
            client.end_txn("tx-a", pid, e0, commit=True)
        # the zombie's data never landed
        assert broker.logs[("t", 0)] == []
        # unknown producer id: INVALID_PRODUCER_ID_MAPPING, fatal
        with pytest.raises(BrokerErrorResponse) as ei:
            client.end_txn("tx-a", 424242, e1, commit=True)
        assert ei.value.code == 49 and not is_retryable(ei.value)
        client.close()
    finally:
        broker.close()


def test_transactional_visibility_and_control_batch_placement():
    """Open transaction: invisible read_committed, visible
    read_uncommitted. EndTxn(commit) writes the control batch at the
    offset AFTER the data (hw includes it; consumers get a null-value
    record there so positions advance), and a second EndTxn answers
    INVALID_TXN_STATE — the resume-commit 'already done' signal."""
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        client = KafkaClient(broker.host, broker.port)
        pid, ep = client.init_producer_id("tx")
        client.add_partitions_to_txn("tx", pid, ep, [("t", 0)])
        client.produce(
            "t", 0, [b"a", b"b"], transactional_id="tx",
            producer_id=pid, producer_epoch=ep,
            base_sequence=0, transactional=True,
        )
        assert read_topic(broker.bootstrap, "t", committed=True) == []
        assert read_topic(broker.bootstrap, "t", committed=False) == [
            b"a", b"b",
        ]
        client.end_txn("tx", pid, ep, commit=True)
        assert read_topic(broker.bootstrap, "t", committed=True) == [
            b"a", b"b",
        ]
        hw, records, _ = client.fetch("t", {0: 0})[0]
        assert hw == 3  # two data offsets + the commit marker
        assert [(o, v) for o, _ts, _k, v in records] == [
            (0, b"a"), (1, b"b"), (2, None),
        ]
        with pytest.raises(BrokerErrorResponse) as ei:
            client.end_txn("tx", pid, ep, commit=True)
        assert ei.value.code == 48
        client.close()
    finally:
        broker.close()


def test_aborted_transaction_stays_invisible_forever():
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        client = KafkaClient(broker.host, broker.port)
        pid, ep = client.init_producer_id("tx")
        client.add_partitions_to_txn("tx", pid, ep, [("t", 0)])
        client.produce(
            "t", 0, [b"discarded"], transactional_id="tx",
            producer_id=pid, producer_epoch=ep,
            base_sequence=0, transactional=True,
        )
        client.end_txn("tx", pid, ep, commit=False)
        assert read_topic(broker.bootstrap, "t", committed=True) == []
        # a later committed transaction interleaves cleanly: only ITS
        # rows surface read_committed, both surface read_uncommitted
        pid, ep = client.init_producer_id("tx")
        client.add_partitions_to_txn("tx", pid, ep, [("t", 0)])
        client.produce(
            "t", 0, [b"kept"], transactional_id="tx",
            producer_id=pid, producer_epoch=ep,
            base_sequence=0, transactional=True,
        )
        client.end_txn("tx", pid, ep, commit=True)
        assert read_topic(broker.bootstrap, "t", committed=True) == [
            b"kept",
        ]
        assert read_topic(broker.bootstrap, "t", committed=False) == [
            b"discarded", b"kept",
        ]
        client.close()
    finally:
        broker.close()


def test_fetch_wire_carries_aborted_transactions_index():
    """Raw v4 read_committed Fetch: the last_stable_offset and the
    (producer_id, first_offset) aborted-transactions index are on the
    wire — the KIP-98 contract the client-side filter consumes."""
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        client = KafkaClient(broker.host, broker.port)
        pid, ep = client.init_producer_id("tx")
        client.add_partitions_to_txn("tx", pid, ep, [("t", 0)])
        client.produce(
            "t", 0, [b"dead"], transactional_id="tx",
            producer_id=pid, producer_epoch=ep,
            base_sequence=0, transactional=True,
        )
        client.end_txn("tx", pid, ep, commit=False)
        client.api_versions()  # pin the modern dialect
        w = Writer()
        w.i32(-1).i32(0).i32(0)  # replica, max_wait, min_bytes
        w.i32(1 << 20).i8(1)  # max_bytes, isolation=read_committed
        w.i32(1).string("t").i32(1)
        w.i32(0).i64(0).i32(1 << 20)
        r = client._call(API_FETCH, 4, w.done())
        r.i32()  # throttle
        assert r.i32() == 1 and r.string() == "t" and r.i32() == 1
        part, err, hw = r.i32(), r.i16(), r.i64()
        lso = r.i64()
        aborted = [(r.i64(), r.i64()) for _ in range(r.i32())]
        assert (part, err) == (0, 0)
        assert hw == 2 and lso == 2  # data + marker, all decided
        assert aborted == [(pid, 0)]
        client.close()
    finally:
        broker.close()


def test_idempotent_produce_dedupes_and_rejects_gaps():
    """Produce-side idempotence without a transaction: a re-send of
    the last appended batch acks with its ORIGINAL base offset and
    appends nothing (DUPLICATE_SEQUENCE_NUMBER, success client-side);
    a sequence gap is OUT_OF_ORDER (45, fatal); a fresh producer
    session must restart sequences at 0."""
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        client = KafkaClient(broker.host, broker.port)
        pid, ep = client.init_producer_id(None)  # idempotence-only
        kw = dict(producer_id=pid, producer_epoch=ep)
        assert client.produce("t", 0, [b"a", b"b"],
                              base_sequence=0, **kw) == 0
        # the wire-retry shape: identical re-send, same base back
        assert client.produce("t", 0, [b"a", b"b"],
                              base_sequence=0, **kw) == 0
        assert [v for _, v in broker.logs[("t", 0)]] == [b"a", b"b"]
        with pytest.raises(BrokerErrorResponse) as ei:
            client.produce("t", 0, [b"gap"], base_sequence=5, **kw)
        assert ei.value.code == 45 and not is_retryable(ei.value)
        assert client.produce("t", 0, [b"c"],
                              base_sequence=2, **kw) == 2
        # new session on the same partition: epoch scopes sequences
        pid2, ep2 = client.init_producer_id(None)
        with pytest.raises(BrokerErrorResponse) as ei:
            client.produce("t", 0, [b"x"], base_sequence=3,
                           producer_id=pid2, producer_epoch=ep2)
        assert ei.value.code == 45
        assert client.produce("t", 0, [b"x"], base_sequence=0,
                              producer_id=pid2,
                              producer_epoch=ep2) == 3
        client.close()
    finally:
        broker.close()


def test_fault_hook_fence_action_turns_holder_into_zombie():
    """The seeded-fault 'fence' action (opt-in, never in the default
    FaultSchedule draw): the broker bumps the requester's epoch
    server-side, so the request itself answers 47 — the shape of a
    competing restart racing the running producer. Re-running
    InitProducerId recovers with a fresh epoch."""
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        armed = {"on": False}

        def hook(api, seq):
            if armed["on"] and api == API_PRODUCE:
                armed["on"] = False
                return "fence"
            return None

        broker.fault_hook = hook
        client = KafkaClient(broker.host, broker.port)
        pid, ep = client.init_producer_id("tx")
        client.add_partitions_to_txn("tx", pid, ep, [("t", 0)])
        armed["on"] = True
        with pytest.raises(ProducerFencedError):
            client.produce(
                "t", 0, [b"z"], transactional_id="tx",
                producer_id=pid, producer_epoch=ep,
                base_sequence=0, transactional=True,
            )
        assert broker.logs[("t", 0)] == []  # fenced data never lands
        pid2, ep2 = client.init_producer_id("tx")
        assert pid2 == pid and ep2 > ep
        client.add_partitions_to_txn("tx", pid2, ep2, [("t", 0)])
        client.produce(
            "t", 0, [b"ok"], transactional_id="tx",
            producer_id=pid2, producer_epoch=ep2,
            base_sequence=0, transactional=True,
        )
        client.end_txn("tx", pid2, ep2, commit=True)
        assert read_topic(broker.bootstrap, "t", committed=True) == [
            b"ok",
        ]
        client.close()
    finally:
        broker.close()


def test_fault_hook_abort_txn_action_is_the_timeout_shape():
    """The 'abort_txn' action aborts the requester's ongoing
    transaction server-side before serving — the transaction-timeout
    shape real brokers add. The commit then answers 48 (nothing open)
    and the rows stay invisible read_committed: exactly the ambiguity
    docs/fault_tolerance.md documents for resumed commits."""
    broker = FakeBroker()
    try:
        broker.create_topic("t")
        armed = {"on": False}

        def hook(api, seq):
            if armed["on"] and api == API_END_TXN:
                armed["on"] = False
                return "abort_txn"
            return None

        broker.fault_hook = hook
        client = KafkaClient(broker.host, broker.port)
        pid, ep = client.init_producer_id("tx")
        client.add_partitions_to_txn("tx", pid, ep, [("t", 0)])
        client.produce(
            "t", 0, [b"timed-out"], transactional_id="tx",
            producer_id=pid, producer_epoch=ep,
            base_sequence=0, transactional=True,
        )
        armed["on"] = True
        with pytest.raises(BrokerErrorResponse) as ei:
            client.end_txn("tx", pid, ep, commit=True)
        assert ei.value.code == 48
        assert read_topic(broker.bootstrap, "t", committed=True) == []
        assert read_topic(broker.bootstrap, "t", committed=False) == [
            b"timed-out",
        ]
        client.close()
    finally:
        broker.close()


def test_transactional_apis_negotiation_and_legacy_refusal():
    """The modern fake broker advertises apis 22/24/26 at v0; a
    legacy broker does not, and because negotiate() blanket-falls-back
    to v0 for OMITTED apis, the transactional path must refuse loudly
    via its own preflight instead of trusting the fallback."""
    broker = FakeBroker()
    try:
        client = KafkaClient(broker.host, broker.port)
        picks = client.api_versions()
        assert picks[API_INIT_PRODUCER_ID] == 0
        client.close()
    finally:
        broker.close()
    legacy = FakeBroker(legacy=True)
    try:
        client = KafkaClient(legacy.host, legacy.port)
        with pytest.raises(KafkaError, match="advertise"):
            client.init_producer_id("tx")
        client.close()
    finally:
        legacy.close()

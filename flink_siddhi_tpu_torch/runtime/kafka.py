"""Kafka-protocol ingestion and egress — no external client library.

The reference's only deployable job is Kafka-in / Kafka-out
(experimental CEPPipeline.scala:49-56, FlinkKafkaConsumer010/
Producer010). This module implements the broker client those adapters
need, directly over TCP (the environment has no kafka client
dependency, and the framework's ingest machinery wants columnar
chunks, not a callback-per-record client anyway). All wire-format
work — message sets, v2 record batches, varints, CRC32C, compression
codecs, version negotiation — lives in ``connectors.kafka``; this
module owns the connection, the request/response flow, and the
engine-facing Source/Sink contracts.

Per connection the client negotiates API versions (ApiVersions,
KIP-35) and speaks the newest dialect both sides implement:

* Metadata   (api 3,  v0)     — partition leaders
* ListOffsets(api 2,  v0)     — earliest/latest offsets
* Fetch      (api 1,  v0/v4)  — v4 returns v2 record batches (CRC32C
  validated, gzip inflated); v0 returns magic 0/1 message sets;
  partial trailing entries truncated either way
* Produce    (api 0,  v0/v3)  — v3 sends v2 record batches with an
  optional compression codec; v0 sends CRC32 message sets, acks=1
* ApiVersions(api 18, v0)     — brokers that slam the connection are
  taken at their word and get the v0 dialect
* InitProducerId (22, v0), AddPartitionsToTxn (24, v0), EndTxn
  (26, v0) — the KIP-98 transactional trio (connectors.kafka.txn);
  only issued against brokers that ADVERTISE them (no v0 fallback:
  a pre-transactions broker cannot speak these at any version)

Offsets are first-class source positions: ``KafkaSource.state_dict``
returns the per-partition next-fetch offsets and participates in the
engine checkpoint exactly like file byte offsets do
(runtime/checkpoint.py), so a restarted pipeline resumes from the
committed position — the role of the reference's Flink-managed Kafka
offsets state. v2 fetches return whole batches, so after a restore
the source skips records below the committed offset instead of
re-consuming them. Record values are newline-free JSON (or CSV) event
payloads decoded by the same native column decoder as every other byte
source (runtime/sources.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..connectors.kafka.codecs import CODEC_NONE, codec_id
from ..connectors.kafka.errors import (
    BrokerClosedError,
    BrokerErrorResponse,
    BrokerIOError,
    DUPLICATE_SEQUENCE_CODE,
    INVALID_TXN_STATE_CODE,
    KafkaError,
    ProducerFencedError,
    broker_code_name,
    broker_error,
    is_connection_error,
    is_retryable,
)
from ..connectors.kafka.retry import RetryPolicy
from ..connectors.kafka.protocol import (
    API_ADD_PARTITIONS_TO_TXN,
    API_END_TXN,
    API_FETCH,
    API_INIT_PRODUCER_ID,
    API_LIST_OFFSETS,
    API_METADATA,
    API_PRODUCE,
    API_VERSIONS,
    Reader,
    Writer,
    decode_api_versions_response,
    negotiate,
    request_header,
)
from ..connectors.kafka.records import (
    MAGIC_V2,
    decode_batch_meta,
    decode_record_batch,
    decode_record_set,
    encode_message_set,
    encode_record_batch,
)
from ..connectors.kafka.txn import (
    DEFAULT_TXN_TIMEOUT_MS,
    TransactionState,
    decode_add_partitions_response,
    decode_end_txn_response,
    decode_init_producer_id_response,
    encode_add_partitions_request,
    encode_end_txn_request,
    encode_init_producer_id_request,
)
from ..schema.batch import EventBatch
from ..schema.stream_schema import StreamSchema
from .sources import Source

__all__ = [
    "DEFAULT_RETRY",
    "EARLIEST",
    "LATEST",
    "KafkaClient",
    "KafkaError",
    "KafkaSink",
    "KafkaSource",
    "ProducerFencedError",
    "RetryPolicy",
]

EARLIEST = -2
LATEST = -1

_LOG = logging.getLogger(__name__)

# Every client retries by default: transient transport failures and
# retryable broker codes (errors.RETRYABLE_BROKER_CODES) reconnect,
# re-negotiate and re-issue; fatal errors propagate on the first hit.
# Pass ``retry=None`` for the raw single-attempt client.
DEFAULT_RETRY = RetryPolicy(
    max_attempts=5, base_delay_ms=20.0, max_delay_ms=2_000.0
)

# Clients that take the shared default get a per-client jitter seed:
# identically-seeded policies produce identical backoff sequences, so
# N clients failing together would retry in lockstep against the
# recovering broker — the stampede the jitter exists to prevent.
# Deterministic per process (a plain counter), distinct per client.
_CLIENT_SEQ = itertools.count()


def _decode_committed(
    rset: bytes, aborted: List[Tuple[int, int]]
) -> List:
    """Read-committed decode of a fetch record set (KIP-98 consumer
    algorithm): walk batches in offset order with the response's
    aborted-transactions index ``[(producer_id, first_offset)]`` —
    when a batch's base offset reaches an index entry, that producer's
    transactional data is aborted until its next control batch (the
    marker) clears it. Aborted data records keep their offsets but
    lose their payloads (``value=None``), exactly like control
    records, so consumers advance past them without observing them."""
    pending = sorted(aborted, key=lambda e: e[1])
    active: set = set()
    out: List = []
    pos, n = 0, len(rset)
    while pos + 17 <= n:
        size = struct.unpack_from(">i", rset, pos + 8)[0]
        if pos + 12 + size > n:
            break  # partial trailing entry (Fetch max_bytes cut)
        magic = rset[pos + 16]
        if magic != MAGIC_V2:
            # legacy entries predate transactions: always committed
            out.extend(decode_record_set(rset[pos : pos + 12 + size]))
            pos += 12 + size
            continue
        meta = decode_batch_meta(rset, pos)
        while pending and pending[0][1] <= meta["base_offset"]:
            active.add(pending.pop(0)[0])
        records, pos = decode_record_batch(rset, pos)
        if meta["control"]:
            # the marker ends its producer's transaction in this
            # partition; records are already nulled by the decoder
            active.discard(meta["producer_id"])
            out.extend(records)
        elif meta["transactional"] and meta["producer_id"] in active:
            out.extend(
                (off, ts, None, None) for off, ts, _k, _v in records
            )
        else:
            out.extend(records)
    return out


# -- client ----------------------------------------------------------------

class KafkaClient:
    """One broker connection. Thread-safe per-call. API versions are
    negotiated on the first request and pinned for the CONNECTION's
    lifetime (``.negotiated`` exposes the picks) — a reconnect after a
    transport failure re-runs ApiVersions, so a transient outage can
    never silently pin the v0 dialect for the client's lifetime.

    ``retry`` (default :data:`DEFAULT_RETRY`) wraps every request in
    exponential backoff with deterministic seeded jitter; each
    retry/reconnect increments a ``faults.kafka.*`` counter, surfaced
    through ``fault_counts`` and (once ``bind_telemetry`` is called —
    the Job does this for every Kafka source) the job's telemetry
    registry."""

    def __init__(
        self, host: str, port: int, client_id: str = "fst",
        timeout_s: float = 10.0,
        retry: Optional[RetryPolicy] = DEFAULT_RETRY,
    ) -> None:
        self.host, self.port = host, int(port)
        self.client_id = client_id
        self._corr = 0
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._timeout = timeout_s
        self._versions: Optional[Dict[int, int]] = None
        # raw ApiVersions advertisement from the broker (None = legacy
        # broker, or not yet negotiated): the transactional preflight
        # reads it — negotiate() falls back to v0 for apis a broker
        # OMITS, which is correct for the legacy data apis but would
        # silently aim transactions at a broker that cannot speak them
        self._broker_versions: Optional[Dict[int, Tuple[int, int]]] = None
        if retry is DEFAULT_RETRY:  # see _CLIENT_SEQ above
            retry = dataclasses.replace(
                retry,
                seed=hash((host, int(port), next(_CLIENT_SEQ)))
                & 0x7FFFFFFF,
            )
        self.retry = retry
        # client-lifetime fault counters (faults.kafka.*); mirrored
        # into a bound MetricsRegistry so retries show up next to the
        # job's other telemetry
        self.fault_counts: Dict[str, int] = {}
        self._telemetry = None

    # -- fault accounting --------------------------------------------------
    def bind_telemetry(self, registry) -> None:
        """Mirror fault counters into a job's MetricsRegistry. Counts
        accumulated before binding (e.g. retries during bootstrap
        metadata) are replayed so the registry view is complete."""
        self._telemetry = registry
        if registry is not None:
            for name, n in self.fault_counts.items():
                registry.inc(name, n)

    def _note_fault(self, name: str, n: int = 1) -> None:
        self.fault_counts[name] = self.fault_counts.get(name, 0) + n
        if self._telemetry is not None:
            self._telemetry.inc(name, n)

    def _retrying(self, op: str, fn):
        """Run one request op under the retry policy: connection-level
        failures tear down the socket AND the negotiated versions
        (reconnect => renegotiate), every retry counts."""
        if self.retry is None:
            return fn()

        def on_retry(exc, attempt, delay_ms):
            self._note_fault("faults.kafka.retries")
            self._note_fault(f"faults.kafka.{op}.retries")
            if is_connection_error(exc):
                with self._lock:
                    self._close_locked()  # drops _versions: renegotiate
                self._note_fault("faults.kafka.reconnects")
            _LOG.warning(
                "kafka %s to %s:%d failed (attempt %d, retrying in "
                "%.0fms): %s", op, self.host, self.port, attempt,
                delay_ms, exc,
            )

        return self.retry.call(fn, classify=is_retryable, on_retry=on_retry)

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        # teardown ALWAYS implies renegotiation: a pinned dialect must
        # not outlive the connection it was negotiated on. Resetting
        # here (not only in the retry hook) covers the paths where
        # on_retry never fires — the final exhausted attempt,
        # retry=None clients, an explicit close(), and a v0 dialect
        # wrongly concluded from transiently-slammed ApiVersions that
        # then "works" (real brokers serve the legacy APIs happily).
        self._versions = None
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self._timeout
            )
        return self._sock

    def _call_locked(self, api: int, version: int, body: bytes) -> Reader:
        self._corr += 1
        corr = self._corr
        head = request_header(api, version, corr, self.client_id)
        frame = struct.pack(">i", len(head) + len(body)) + head + body
        try:
            s = self._conn()
            s.sendall(frame)
            raw = self._read_frame(s)
        except OSError as e:
            self._close_locked()
            raise BrokerIOError(f"broker io error: {e}") from e
        r = Reader(raw)
        got = r.i32()
        if got != corr:
            # request/response desync: the socket is unusable, but a
            # reconnect re-syncs — transport-level, hence retryable
            self._close_locked()
            raise BrokerIOError(f"correlation mismatch ({got} != {corr})")
        return r

    def _call(self, api: int, version: int, body: bytes) -> Reader:
        with self._lock:
            return self._call_locked(api, version, body)

    @staticmethod
    # fst:blocking-ok thread-safe-per-call by design: the client lock IS the request slot, held across the whole round trip so concurrent callers cannot interleave frames on one socket
    def _read_frame(s: socket.socket) -> bytes:
        head = b""
        while len(head) < 4:
            chunk = s.recv(4 - len(head))
            if not chunk:
                raise BrokerClosedError("broker closed connection")
            head += chunk
        (size,) = struct.unpack(">i", head)
        out = bytearray()
        while len(out) < size:
            chunk = s.recv(min(1 << 16, size - len(out)))
            if not chunk:
                raise BrokerClosedError("broker closed mid-frame")
            out += chunk
        return bytes(out)

    # -- version negotiation ----------------------------------------------
    @property
    def negotiated(self) -> Optional[Dict[int, int]]:
        """{api: pinned version} after the first request, else None."""
        return self._versions

    def _ensure_versions_locked(self) -> Dict[int, int]:
        if self._versions is None:
            # A pre-0.10 broker answers ApiVersions by slamming the
            # ESTABLISHED connection — but so does a transient fault
            # that drops the connection mid-response. The two are
            # distinguishable only by retrying: a legacy broker slams
            # EVERY attempt (deterministically), a transient fault
            # passes on a later one. Only all-attempts-slammed
            # concludes the v0 dialect; any other failure (connection
            # refused, timeout, garbled response) propagates — a
            # transient outage must not pin v0. And since EVERY
            # teardown resets ``_versions`` (``_close_locked``), even
            # a wrong conclusion lasts one connection, not the
            # client's life.
            attempts = self.retry.max_attempts if self.retry else 1
            # constant SHORT backoff, not the exponential sequence:
            # these sleeps run under self._lock (every other call on
            # this client gates on the negotiated versions anyway, so
            # waiting on the lock == waiting on negotiation), and the
            # outer per-op retry already owns real backoff — this
            # inner loop exists only to distinguish a legacy broker
            # (slams EVERY attempt) from a transient fault (passes on
            # a later one). Exponential growth here would multiply
            # under the outer retry into seconds of lock-held sleep.
            delay_s = (
                min(self.retry.base_delay_ms, 50.0) / 1e3
                if self.retry
                else 0.0
            )
            broker = None
            for i in range(max(attempts, 1)):
                try:
                    r = self._call_locked(API_VERSIONS, 0, b"")
                    broker = decode_api_versions_response(r)
                    break
                except BrokerClosedError:
                    self._close_locked()
                    broker = None
                    if i < attempts - 1:
                        self._note_fault(
                            "faults.kafka.negotiation.retries"
                        )
                        # fst:blocking-ok constant <=50ms delay, never the exponential sequence (see comment above): every other call on this client gates on negotiation anyway, so waiting on the lock == waiting on negotiation — the PR 7 bug was the EXPONENTIAL backoff here
                        time.sleep(delay_s)
            self._broker_versions = broker
            self._versions = negotiate(broker)
        return self._versions

    def api_versions(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._ensure_versions_locked())

    # -- requests ---------------------------------------------------------
    def metadata(self, topics: List[str]) -> Dict:
        return self._retrying("metadata", lambda: self._metadata_once(topics))

    def _metadata_once(self, topics: List[str]) -> Dict:
        w = Writer().i32(len(topics))
        for t in topics:
            w.string(t)
        r = self._call(API_METADATA, 0, w.done())
        brokers = {}
        for _ in range(r.i32()):
            node, host, port = r.i32(), r.string(), r.i32()
            brokers[node] = (host, port)
        out = {"brokers": brokers, "topics": {}}
        for _ in range(r.i32()):
            terr = r.i16()
            tname = r.string()
            parts = {}
            for _ in range(r.i32()):
                perr, pid, leader = r.i16(), r.i32(), r.i32()
                for _ in range(r.i32()):
                    r.i32()  # replicas
                for _ in range(r.i32()):
                    r.i32()  # isr
                parts[pid] = {"error": perr, "leader": leader}
            out["topics"][tname] = {"error": terr, "partitions": parts}
        return out

    def list_offsets(
        self, topic: str, partitions: List[int], time: int = EARLIEST
    ) -> Dict[int, int]:
        return self._retrying(
            "list_offsets",
            lambda: self._list_offsets_once(topic, partitions, time),
        )

    def _list_offsets_once(
        self, topic: str, partitions: List[int], time: int
    ) -> Dict[int, int]:
        w = Writer().i32(-1).i32(1).string(topic).i32(len(partitions))
        for p in partitions:
            w.i32(p).i64(time).i32(1)
        r = self._call(API_LIST_OFFSETS, 0, w.done())
        out: Dict[int, int] = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                pid, err = r.i32(), r.i16()
                offs = [r.i64() for _ in range(r.i32())]
                if err:
                    raise BrokerErrorResponse(
                        f"ListOffsets {topic}/{pid}: error {err} "
                        f"({broker_code_name(err)})",
                        code=err, api="ListOffsets",
                    )
                out[pid] = offs[0] if offs else 0
        return out

    def fetch(
        self,
        topic: str,
        offsets: Dict[int, int],
        max_bytes: int = 1 << 20,
        max_wait_ms: int = 100,
        min_bytes: int = 1,
        isolation: int = 0,
    ) -> Dict[int, Tuple[int, List, int]]:
        """-> {partition: (high_watermark, [(offset, ts, key, value)],
        raw_record_set_bytes)} — the raw size lets callers distinguish
        'no data' from 'a single entry larger than max_bytes'. With a
        negotiated Fetch >= 4 the records arrive as v2 batches
        (CRC32C-checked, decompressed); either way records below the
        requested offset may appear (whole-batch/segment resends) and
        callers must skip them.

        ``isolation=1`` (read_committed; needs Fetch >= 4) serves only
        up to the partition's last stable offset and filters ABORTED
        transactional data client-side using the response's
        aborted-transactions index, the way real consumers do: an
        aborted batch's records are returned with ``None`` values so
        offsets still advance past them (exactly like control
        batches), but no payload survives."""
        return self._retrying(
            "fetch",
            lambda: self._fetch_once(
                topic, offsets, max_bytes, max_wait_ms, min_bytes,
                isolation,
            ),
        )

    def _fetch_once(
        self,
        topic: str,
        offsets: Dict[int, int],
        max_bytes: int,
        max_wait_ms: int,
        min_bytes: int,
        isolation: int = 0,
    ) -> Dict[int, Tuple[int, List, int]]:
        with self._lock:
            version = self._ensure_versions_locked()[API_FETCH]
            if isolation and version < 4:
                raise KafkaError(
                    "read_committed needs a broker speaking Fetch >= 4"
                    " (v2 record batches carry the transactional "
                    "attribution); this broker negotiated the v0 "
                    "dialect"
                )
            w = Writer().i32(-1).i32(max_wait_ms).i32(min_bytes)
            if version >= 4:
                w.i32(max_bytes).i8(isolation)
            w.i32(1).string(topic).i32(len(offsets))
            for p, off in sorted(offsets.items()):
                w.i32(p).i64(off).i32(max_bytes)
            r = self._call_locked(API_FETCH, version, w.done())
        if version >= 4:
            r.i32()  # throttle_time_ms
        out: Dict[int, Tuple[int, List, int]] = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                pid, err, hw = r.i32(), r.i16(), r.i64()
                aborted: List[Tuple[int, int]] = []
                if version >= 4:
                    r.i64()  # last_stable_offset
                    for _ in range(r.i32()):  # aborted_transactions
                        aborted.append((r.i64(), r.i64()))
                rset = r.bytes_() or b""
                if err:
                    raise BrokerErrorResponse(
                        f"Fetch {topic}/{pid}: error {err} "
                        f"({broker_code_name(err)})",
                        code=err, api="Fetch",
                    )
                if isolation:
                    records = _decode_committed(rset, aborted)
                else:
                    records = decode_record_set(rset)
                out[pid] = (hw, records, len(rset))
        return out

    def produce(
        self,
        topic: str,
        partition: int,
        values: List[bytes],
        acks: int = 1,
        timeout_ms: int = 10_000,
        ts_ms: int = 0,
        compression: str = "none",
        transactional_id: Optional[str] = None,
        producer_id: int = -1,
        producer_epoch: int = -1,
        base_sequence: int = -1,
        transactional: bool = False,
    ) -> int:
        """-> base offset assigned by the broker. ``compression`` is a
        codecs.py name; anything but 'none' needs a broker speaking
        Produce >= 3 (v2 record batches).

        PLAIN retried produce (no producer id) is AT-LEAST-ONCE: a
        request that failed after the broker appended it (e.g. the ack
        was lost to a connection drop) is re-sent whole with nothing
        for the broker to dedupe against. Passing the KIP-98 fields
        (``producer_id``/``producer_epoch``/``base_sequence``, granted
        by :meth:`init_producer_id`) closes that hole: the broker acks
        a re-send of an already-appended batch as
        DUPLICATE_SEQUENCE_NUMBER, which this method treats as success
        — the batch landed exactly once. ``transactional=True``
        additionally marks the batch invisible to read-committed
        consumers until its transaction commits (the ``KafkaSink``
        transactional path binds that commit to the supervisor's
        checkpoint-commit protocol). A stale epoch raises
        ``ProducerFencedError`` (fatal: this producer is a zombie)."""
        return self._retrying(
            "produce",
            lambda: self._produce_once(
                topic, partition, values, acks, timeout_ms, ts_ms,
                compression, transactional_id, producer_id,
                producer_epoch, base_sequence, transactional,
            ),
        )

    def _produce_once(
        self,
        topic: str,
        partition: int,
        values: List[bytes],
        acks: int,
        timeout_ms: int,
        ts_ms: int,
        compression: str,
        transactional_id: Optional[str] = None,
        producer_id: int = -1,
        producer_epoch: int = -1,
        base_sequence: int = -1,
        transactional: bool = False,
    ) -> int:
        codec = codec_id(compression)
        with self._lock:
            version = self._ensure_versions_locked()[API_PRODUCE]
            if version >= 3:
                rset = encode_record_batch(
                    [(ts_ms, None, v) for v in values],
                    codec=codec,
                    producer_id=producer_id,
                    producer_epoch=producer_epoch,
                    base_sequence=base_sequence,
                    transactional=transactional,
                )
            else:
                if producer_id >= 0 or transactional:
                    raise KafkaError(
                        "idempotent/transactional produce needs a "
                        "broker speaking Produce >= 3 (v2 record "
                        "batches carry the producer fields); this "
                        "broker negotiated the v0 dialect"
                    )
                if codec != CODEC_NONE:
                    raise KafkaError(
                        f"compression {compression!r} needs a broker "
                        "speaking Produce >= 3 (v2 record batches); "
                        "this broker negotiated the v0 dialect — "
                        "produce uncompressed or upgrade the broker"
                    )
                rset = encode_message_set(values, ts_ms=ts_ms)
            w = Writer()
            if version >= 3:
                w.string(transactional_id)
            (
                w.i16(acks)
                .i32(timeout_ms)
                .i32(1)
                .string(topic)
                .i32(1)
                .i32(partition)
                .bytes_(rset)
            )
            r = self._call_locked(API_PRODUCE, version, w.done())
        base = -1
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                pid, err, off = r.i32(), r.i16(), r.i64()
                if version >= 2:
                    r.i64()  # log_append_time
                if err == DUPLICATE_SEQUENCE_CODE and producer_id >= 0:
                    # the retry-after-append shape: the broker already
                    # holds this batch at ``off`` — exactly-once, done
                    base = off
                    continue
                if err:
                    raise broker_error(
                        f"Produce {topic}/{pid}: error {err} "
                        f"({broker_code_name(err)})",
                        code=err, api="Produce",
                    )
                base = off
        return base

    # -- transactions (KIP-98) --------------------------------------------
    def _txn_preflight_locked(self) -> None:
        """Transactions need the broker to ADVERTISE apis 22/24/26 —
        negotiate() falls back to v0 for omitted apis (right for the
        legacy data dialect, wrong here: a pre-transactions broker
        would just hang up on an InitProducerId)."""
        self._ensure_versions_locked()
        adv = self._broker_versions
        if adv is None or API_INIT_PRODUCER_ID not in adv:
            raise KafkaError(
                f"broker {self.host}:{self.port} does not advertise "
                "the transactional apis (InitProducerId/"
                "AddPartitionsToTxn/EndTxn) — transactional produce "
                "needs a >= 0.11 broker"
            )

    def init_producer_id(
        self,
        transactional_id: Optional[str],
        txn_timeout_ms: int = DEFAULT_TXN_TIMEOUT_MS,
    ) -> Tuple[int, int]:
        """-> ``(producer_id, producer_epoch)``. Re-running on the
        same transactional id bumps the epoch: every older holder is
        FENCED and any transaction it left open is aborted broker-side
        — the restart/zombie half of exactly-once output."""
        return self._retrying(
            "init_producer_id",
            lambda: self._init_producer_id_once(
                transactional_id, txn_timeout_ms
            ),
        )

    def _init_producer_id_once(
        self, transactional_id: Optional[str], txn_timeout_ms: int
    ) -> Tuple[int, int]:
        with self._lock:
            self._txn_preflight_locked()
            r = self._call_locked(
                API_INIT_PRODUCER_ID,
                0,
                encode_init_producer_id_request(
                    transactional_id, txn_timeout_ms
                ),
            )
        return decode_init_producer_id_response(r)

    def add_partitions_to_txn(
        self,
        transactional_id: str,
        producer_id: int,
        producer_epoch: int,
        partitions: List[Tuple[str, int]],
    ) -> None:
        """Register partitions with the ongoing transaction (where
        commit/abort markers will be written) before producing."""
        self._retrying(
            "add_partitions_to_txn",
            lambda: self._add_partitions_once(
                transactional_id, producer_id, producer_epoch,
                partitions,
            ),
        )

    def _add_partitions_once(
        self,
        transactional_id: str,
        producer_id: int,
        producer_epoch: int,
        partitions: List[Tuple[str, int]],
    ) -> None:
        with self._lock:
            self._txn_preflight_locked()
            r = self._call_locked(
                API_ADD_PARTITIONS_TO_TXN,
                0,
                encode_add_partitions_request(
                    transactional_id, producer_id, producer_epoch,
                    partitions,
                ),
            )
        decode_add_partitions_response(r)

    def end_txn(
        self,
        transactional_id: str,
        producer_id: int,
        producer_epoch: int,
        commit: bool,
    ) -> None:
        """Two-phase commit's second phase: the coordinator writes the
        COMMIT/ABORT marker into every registered partition."""
        self._retrying(
            "end_txn",
            lambda: self._end_txn_once(
                transactional_id, producer_id, producer_epoch, commit
            ),
        )

    def _end_txn_once(
        self,
        transactional_id: str,
        producer_id: int,
        producer_epoch: int,
        commit: bool,
    ) -> None:
        with self._lock:
            self._txn_preflight_locked()
            r = self._call_locked(
                API_END_TXN,
                0,
                encode_end_txn_request(
                    transactional_id, producer_id, producer_epoch,
                    commit,
                ),
            )
        decode_end_txn_response(r)


# -- source / sink ---------------------------------------------------------

class KafkaSource(Source):
    """Consume a topic's partitions into columnar EventBatches.

    Record values are newline-free JSON objects (``fmt='json'``) or CSV
    rows (``fmt='csv'``), decoded by the native column decoder — one
    record per event, so offsets map 1:1 to rows and the checkpointed
    position is exact. Timestamps: ``ts_field`` (epoch ms) when given,
    else the message timestamp (magic>=1 / v2 batches), else arrival
    order.

    The source is unbounded (done only after ``close()`` AND the
    backlog drains), matching SocketLineSource's contract."""

    def __init__(
        self,
        stream_id: str,
        schema: StreamSchema,
        bootstrap: str,  # "host:port"
        topic: str,
        fmt: str = "json",
        delim: str = ",",
        ts_field: Optional[str] = None,
        start: int = EARLIEST,
        max_bytes: int = 1 << 20,
        allowed_lateness_ms: int = 0,
        client: Optional[KafkaClient] = None,
        watermark=None,  # WatermarkStrategy template, cloned per partition
        idle_timeout_ms: Optional[float] = None,
    ) -> None:
        from .sources import make_column_decoder

        if fmt not in ("json", "csv"):
            raise ValueError(fmt)
        self.stream_id = stream_id
        self.schema = schema
        self.topic = topic
        self._fmt = fmt
        self._delim = delim
        self._ts_field = ts_field
        self._max_bytes = max_bytes
        self._lateness = int(allowed_lateness_ms)
        self._arrival = 0
        # fst:ephemeral close() marker: a restored source is open by construction
        self._closed = False
        if client is None:
            host, _, port = bootstrap.partition(":")
            client = KafkaClient(host, int(port or 9092))
        self.client = client
        meta = self.client.metadata([topic])
        tmeta = meta["topics"].get(topic)
        if tmeta is None or tmeta["error"]:
            raise KafkaError(f"topic {topic!r} unavailable")
        parts = sorted(tmeta["partitions"])
        # CONSUMED position per partition — what checkpoints record
        self.offsets: Dict[int, int] = dict(
            self.client.list_offsets(topic, parts, start)
        )
        # fetch position runs ahead of the consumed position: fetched-
        # but-not-yet-consumed records wait in _buffer instead of being
        # re-transferred every poll when max_events < a fetch's worth
        self._fetch_pos: Dict[int, int] = dict(self.offsets)
        self._buffer: List[Tuple[int, int, Optional[int], bytes]] = []
        # partition high watermarks, recorded per fetch; absent =
        # unknown, which must read as "assume a backlog" (a close()
        # before the first fetch still drains the topic)
        self._hw: Dict[int, int] = {}
        self._fields, self._decoder = make_column_decoder(schema)
        # timestamp basis, decided ONCE at the first consumed batch:
        # 'field' (ts_field), 'message' (magic>=1 broker timestamps) or
        # 'arrival'. Re-deciding per batch would let one magic-0
        # message flip the basis mid-stream and wreck the watermark.
        self._ts_basis = "field" if ts_field is not None else None
        # per-partition watermark generation (docs/event_time.md): one
        # strategy clone per assigned partition, each observing only
        # its own records' event times; the SOURCE watermark is the min
        # across partitions that have produced at least one record (two
        # partitions never arrive aligned — the min is what makes the
        # claim safe). A partition that has never produced does not pin
        # the min; once it produces, its strategy joins it. Without a
        # strategy the historical max-ts-minus-allowed_lateness claim
        # stands.
        self._wm_template = watermark
        self._wm_strategies = (
            {p: watermark.clone() for p in parts}
            if watermark is not None
            else None
        )
        # PER-PARTITION IDLENESS (the event-time carried item from
        # PR 10): a partition that produced at least once pins this
        # source's min-across-partitions claim FOREVER if it goes
        # silent — before this knob, only the job-level idle timeout
        # (which silences the whole source) could unpin the stream.
        # A partition with no records for idle_timeout_ms is excluded
        # from the min (0 = excluded on the first poll it sits out,
        # deterministic for tests; None disables — historical
        # behavior); it un-idles on its next record, and its
        # now-possibly-late rows are the gate's late-policy problem,
        # exactly like an un-idling source (Flink idleness semantics).
        # Idle FLAGS are checkpointed; the monotonic clocks re-arm.
        self._idle_timeout_ms = (
            None if idle_timeout_ms is None else float(idle_timeout_ms)
        )
        self._part_idle: Dict[int, bool] = {p: False for p in parts}
        # fst:ephemeral monotonic idle clocks re-arm at resume; the per-partition idle FLAGS are checkpointed
        self._part_last_t: Dict[int, Optional[float]] = {
            p: None for p in parts
        }
        # fst:ephemeral registry handle; Job.__init__ re-binds after restore
        self._telemetry = None

    def _partition_watermark(self) -> Optional[int]:
        """min across partitions that have observed >= 1 record,
        excluding partitions currently marked idle. All-idle = None
        (the claim HOLDS at its last published value — idle means 'no
        information', not 'stream complete')."""
        wms = [
            w
            for p, s in self._wm_strategies.items()
            if not self._part_idle.get(p, False)
            for w in (s.current(),)
            if w is not None
        ]
        return min(wms) if wms else None

    def _pending_partitions(self) -> set:
        """Partitions with EVIDENCE of data not yet consumed: records
        waiting in the fetch buffer, a fetch position behind the known
        broker high watermark, or no high watermark observed yet
        (unknown = assume a backlog, the same rule _refill applies).
        These are not silent — idling one would misclassify its
        still-queued rows as late once they drain (a high-volume
        sibling partition can monopolize poll's max_events slice for
        many polls)."""
        pending = {pid for pid, _o, _t, _v in self._buffer}
        for p, pos in self._fetch_pos.items():
            if pos < self._hw.get(p, 1 << 62):
                pending.add(p)
        return pending

    def _track_partition_idleness(self, produced) -> None:
        """Advance the per-partition idle state machine for one poll:
        ``produced`` partitions — consumed this poll OR with pending
        unconsumed evidence (see _pending_partitions) — re-arm (and
        un-idle); the rest idle once their clock passes the timeout.
        Runs on EMPTY polls too — a backlog on one partition must not
        need fresh records on another to unpin."""
        now = time.monotonic()
        produced = set(produced) | self._pending_partitions()
        for p in self._part_idle:
            if p in produced:
                self._part_last_t[p] = now
                if self._part_idle[p]:
                    self._part_idle[p] = False
                    if self._telemetry is not None:
                        self._telemetry.inc("idle.partition_unidled")
            elif not self._part_idle[p]:
                if self._part_last_t[p] is None:
                    self._part_last_t[p] = now  # arm at first poll
                if (now - self._part_last_t[p]) * 1e3 >= (
                    self._idle_timeout_ms
                ):
                    self._part_idle[p] = True
                    if self._telemetry is not None:
                        self._telemetry.inc("idle.partition_marked")
                    _LOG.debug(
                        "%s/%d: partition idle; excluded from the "
                        "min watermark until its next record",
                        self.topic, p,
                    )

    def close(self) -> None:
        """Stop consuming after the current backlog drains."""
        self._closed = True

    def bind_telemetry(self, registry) -> None:
        """Mirror the client's faults.kafka.* counters into the job's
        registry (Job.__init__ calls this for every source that has
        it); partition-idleness transitions count here too."""
        self.client.bind_telemetry(registry)
        # fst:ephemeral registry handle; Job.__init__ re-binds after restore
        self._telemetry = registry

    def _refill(self) -> None:
        """One Fetch for every partition whose fetch position is not
        known-drained; buffered records carry (pid, offset, ts, value).
        Records below the fetch position — legacy segment-start resends
        AND the head of a v2 batch the committed offset landed inside —
        are skipped, never re-consumed."""
        want = {
            p: o
            for p, o in self._fetch_pos.items()
            if not (self._closed and o >= self._hw.get(p, 1 << 62))
        }
        if not want:
            return
        fetched = self.client.fetch(
            self.topic, want, max_bytes=self._max_bytes
        )
        for pid, (hw, msgs, raw_len) in sorted(fetched.items()):
            self._hw[pid] = hw
            advanced = False
            for off, ts, _key, value in msgs:
                if off < self._fetch_pos[pid]:
                    continue  # already consumed (see docstring)
                if value is not None:
                    self._buffer.append((pid, off, ts, value))
                self._fetch_pos[pid] = off + 1
                advanced = True
            if (
                not advanced
                and self._fetch_pos[pid] < hw
                and raw_len > 0
            ):
                # a non-empty record set with no complete entry at
                # max_bytes: the next entry cannot fit — without this
                # check the pipeline would spin on the same offset
                raise KafkaError(
                    f"{self.topic}/{pid}: record at offset "
                    f"{self._fetch_pos[pid]} exceeds max_bytes="
                    f"{self._max_bytes}; raise KafkaSource(max_bytes=)"
                )

    def poll(self, max_events: int):
        if len(self._buffer) < max_events:
            self._refill()
        take = self._buffer[:max_events]
        self._buffer = self._buffer[max_events:]
        values: List[bytes] = []
        msg_ts: List[Optional[int]] = []
        for pid, off, ts, value in take:
            values.append(value)
            msg_ts.append(ts)
            self.offsets[pid] = off + 1
        backlog = bool(self._buffer) or any(
            self._fetch_pos[p] < self._hw.get(p, 1 << 62)
            for p in self._fetch_pos
        )
        if not values:
            if self._closed and not backlog:
                self.client.close()
                return None, np.iinfo(np.int64).max, True
            if (
                self._wm_strategies is not None
                and self._idle_timeout_ms is not None
            ):
                # an all-empty poll still advances the idle state
                # machine AND republishes the min: the laggard's
                # exclusion must not wait for fresh records on some
                # other partition (the claim only ever tightens — the
                # executor maxes source claims)
                self._track_partition_idleness(produced=frozenset())
                return None, self._partition_watermark(), False
            return None, None, False
        from .sources import decoded_columns

        data = b"\n".join(v.replace(b"\n", b" ") for v in values) + b"\n"
        if self._fmt == "json":
            cols, valid, n = self._decoder.decode_json(data, len(values))
        else:
            cols, valid, n = self._decoder.decode_csv(
                data, len(values), self._delim
            )
        columns = decoded_columns(self._fields, self.schema, cols)
        if self._ts_basis is None:
            self._ts_basis = (
                "message"
                if all(t is not None for t in msg_ts)
                else "arrival"
            )
        if self._ts_basis == "field":
            ts = columns[self._ts_field].astype(np.int64)
        elif self._ts_basis == "message":
            if any(t is None for t in msg_ts):
                raise KafkaError(
                    f"{self.topic}: mixed message formats — some "
                    "records lack broker timestamps; pass ts_field= "
                    "to take event time from the payload instead"
                )
            ts = np.asarray(msg_ts, dtype=np.int64)
        else:
            ts = self._arrival + np.arange(n, dtype=np.int64)
            self._arrival += n
        keep = valid.astype(bool)
        pids = np.fromiter((t[0] for t in take), np.int32, len(take))
        if not keep.all():
            columns = {k: v[keep] for k, v in columns.items()}
            ts = ts[keep]
            pids = pids[keep]
        batch = EventBatch(self.stream_id, self.schema, columns, ts)
        if self._wm_strategies is not None:
            # per-partition generation: each partition's strategy sees
            # only its own records' event times; the published claim is
            # the min across producing, non-idle partitions
            produced = set()
            for p in np.unique(pids).tolist():
                strat = self._wm_strategies.get(p)
                if strat is None:  # defensive: unassigned pid appeared
                    strat = self._wm_strategies[p] = (
                        self._wm_template.clone()
                    )
                    self._part_idle.setdefault(p, False)
                    self._part_last_t.setdefault(p, None)
                strat.observe(ts[pids == p])
                produced.add(p)
            if self._idle_timeout_ms is not None:
                self._track_partition_idleness(produced)
            wm = self._partition_watermark()
        else:
            wm = int(ts.max()) - self._lateness if len(ts) else None
        done = self._closed and not backlog
        if done:
            wm = np.iinfo(np.int64).max
            self.client.close()
        return (batch if len(ts) else None), wm, done

    # -- checkpoint: CONSUMED offsets are the source position -------------
    def state_dict(self) -> dict:
        d = {
            "offsets": {str(p): o for p, o in self.offsets.items()},
            "arrival": self._arrival,
            "ts_basis": self._ts_basis,
        }
        if self._wm_strategies is not None:
            # per-partition watermark state rides the checkpoint: a
            # restored source must not re-publish an early watermark
            # (it would re-admit rows the gate already classified)
            d["wm"] = {
                str(p): s.state_dict()
                for p, s in self._wm_strategies.items()
            }
            # idle FLAGS survive restore (an idle partition must not
            # re-pin the claim it was excluded from); the monotonic
            # clocks re-arm at resume
            d["part_idle"] = {
                str(p): bool(b) for p, b in self._part_idle.items()
            }
        return d

    def load_state_dict(self, d: dict) -> None:
        self.offsets = {int(p): int(o) for p, o in d["offsets"].items()}
        if d.get("wm") is not None and self._wm_strategies is not None:
            for p, sd in d["wm"].items():
                strat = self._wm_strategies.get(int(p))
                if strat is None and self._wm_template is not None:
                    strat = self._wm_strategies[int(p)] = (
                        self._wm_template.clone()
                    )
                if strat is not None:
                    strat.load_state_dict(sd)
        if d.get("part_idle") is not None:
            for p, b in d["part_idle"].items():
                self._part_idle[int(p)] = bool(b)
                self._part_last_t.setdefault(int(p), None)
        # fetched-but-unconsumed records are not part of the snapshot:
        # refetch from the restored consumed position (v2 fetches
        # return the whole containing batch; _refill skips the
        # already-consumed head)
        self._fetch_pos = dict(self.offsets)
        self._buffer = []
        self._arrival = int(d.get("arrival", 0))
        if d.get("ts_basis") is not None:
            self._ts_basis = d["ts_basis"]


class KafkaSink:
    """Produce emitted rows to a topic as JSON objects (one per row) —
    attach with ``job.add_sink(stream, sink)``; call ``flush()`` (or use
    the pipeline wiring, which flushes per drain) to bound batching.
    ``compression`` is a codecs.py name applied per produced batch
    (requires a broker negotiating Produce >= 3).

    **Transactional mode** (``transactional_id=...``): the two-phase-
    commit sink (Flink lineage, PAPERS.md #1). Each checkpoint epoch
    ``n`` gets its own transaction on the epoch-suffixed id
    ``f"{transactional_id}-{n}"``; rows flush into the OPEN transaction
    (idempotent produce: producer id/epoch/sequence per batch, so a
    wire-level retry can never double-append) and stay invisible to
    read-committed consumers until the supervisor's commit protocol
    commits the checkpoint — ``prepare_commit()`` (flush + stamp the
    pending transaction into the snapshot via ``state_dict``) runs
    before the snapshot is captured, ``commit_transaction()`` (EndTxn)
    only after it is durably on disk. A crash between the two is
    healed at restore: ``load_state_dict`` RESUMES the snapshot's
    pending commit (an INVALID_TXN_STATE answer means the commit
    already landed pre-crash — success either way), then re-runs
    InitProducerId on the next epoch's id, which aborts whatever the
    pre-crash zombie left open and fences the zombie itself
    (``ProducerFencedError``, fatal, on its next produce). Net effect:
    an external read-committed consumer sees every committed row
    exactly once across any crash point — the suffix a restart
    discards and re-emits is aborted broker-side, never observed.

    Transaction lifecycle events journal to the flight recorder
    (``txn.begin/commit/abort/fenced``, abort storms rate-collapsed)
    and mirror as ``faults.txn.*`` counters once ``bind_telemetry`` /
    ``bind_flightrec`` are called (``job.add_sink`` does both)."""

    def __init__(
        self,
        bootstrap: str,
        topic: str,
        field_names: List[str],
        stream_id: Optional[str] = None,
        partition: int = 0,
        flush_every: int = 1024,
        compression: str = "none",
        client: Optional[KafkaClient] = None,
        transactional_id: Optional[str] = None,
        txn_timeout_ms: int = DEFAULT_TXN_TIMEOUT_MS,
    ) -> None:
        import json as _json

        codec_id(compression)  # fail on unknown names at build time
        if client is None:
            host, _, port = bootstrap.partition(":")
            client = KafkaClient(host, int(port or 9092))
        self.client = client
        self.topic = topic
        self.partition = partition
        self.names = list(field_names)
        self.stream_id = stream_id
        self.flush_every = flush_every
        self.compression = compression
        # fst:ephemeral drained into the open transaction by prepare_commit before every snapshot (plain sinks re-emit on replay, at-least-once)
        self._buf: List[bytes] = []
        self._json = _json
        self.produced = 0
        # -- transactional state ------------------------------------
        self.transactional_id = transactional_id
        self._txn_timeout_ms = int(txn_timeout_ms)
        self._txn: Optional[TransactionState] = None
        #: checkpoint-epoch counter: transaction n runs on the id
        #: f"{transactional_id}-{n}" (fresh id per epoch, so a
        #: restored job's InitProducerId aborts exactly the zombie's
        #: orphan and nothing else)
        self._epoch_n = 0
        #: the prepared-but-uncommitted transaction's identity — set
        #: by prepare_commit, carried in state_dict, consumed by
        #: commit_transaction (or by load_state_dict's resume)
        self._pending: Optional[dict] = None
        self.txn_commits = 0
        self.txn_aborts = 0
        self.txn_fenced = 0
        self.txn_resumed = 0
        # fst:ephemeral observability handles; job.add_sink re-binds after restore
        self._flightrec = None

    @property
    def transactional(self) -> bool:
        return self.transactional_id is not None

    def __call__(self, ts: int, row: tuple) -> None:
        # mirror the file sink's payload shape (app/pipeline.py): the
        # stream id disambiguates multi-output plans sharing one topic
        obj = (
            {"stream": self.stream_id, "ts": int(ts)}
            if self.stream_id is not None
            else {"ts": int(ts)}
        )
        obj.update(zip(self.names, row))
        self._buf.append(
            self._json.dumps(obj, separators=(",", ":")).encode()
        )
        if len(self._buf) >= self.flush_every:
            self.flush()

    def bind_telemetry(self, registry) -> None:
        self.client.bind_telemetry(registry)

    def bind_flightrec(self, recorder) -> None:
        """Journal txn lifecycle events into the job's flight
        recorder, scoped by the sink's stream (or topic)."""
        # fst:ephemeral recorder handle; job.add_sink re-binds after restore
        self._flightrec = recorder

    def _txn_event(self, kind: str, **data) -> None:
        """One txn lifecycle event: flight-recorder journal entry
        (rate-collapsed for abort storms) + faults.txn.* counter."""
        self.client._note_fault(f"faults.txn.{kind.split('.', 1)[1]}")
        if self._flightrec is not None:
            self._flightrec.record(
                kind, plan=self.stream_id or self.topic, **data
            )

    # -- transactional plumbing -----------------------------------------
    def _txn_id_for(self, n: int) -> str:
        return f"{self.transactional_id}-{int(n)}"

    def _ensure_session(self) -> None:
        """InitProducerId for the current epoch's id (idempotent per
        epoch). THIS is the call that aborts an orphan transaction a
        pre-crash zombie left on this id and fences the zombie."""
        if self._txn is not None:
            return
        txn_id = self._txn_id_for(self._epoch_n)
        pid, epoch = self.client.init_producer_id(
            txn_id, self._txn_timeout_ms
        )
        st = TransactionState(txn_id)
        st.open(pid, epoch)
        self._txn = st

    def _ensure_txn(self) -> None:
        self._ensure_session()
        if not self._txn.in_txn:
            self._txn.begin()
            self._txn_event(
                "txn.begin",
                txn_id=self._txn.transactional_id,
                producer_id=self._txn.producer_id,
                producer_epoch=self._txn.producer_epoch,
            )

    def flush(self) -> None:
        if not self._buf:
            return
        if not self.transactional:
            self.client.produce(
                self.topic, self.partition, self._buf,
                compression=self.compression,
            )
            self.produced += len(self._buf)
            self._buf = []
            return
        try:
            self._ensure_txn()
            st = self._txn
            if st.needs_partition(self.topic, self.partition):
                self.client.add_partitions_to_txn(
                    st.transactional_id,
                    st.producer_id,
                    st.producer_epoch,
                    [(self.topic, self.partition)],
                )
                st.partition_added(self.topic, self.partition)
            self.client.produce(
                self.topic, self.partition, self._buf,
                compression=self.compression,
                transactional_id=st.transactional_id,
                producer_id=st.producer_id,
                producer_epoch=st.producer_epoch,
                base_sequence=st.next_sequence(
                    self.topic, self.partition
                ),
                transactional=True,
            )
            st.advance(self.topic, self.partition, len(self._buf))
        except ProducerFencedError:
            self.txn_fenced += 1
            self._txn_event(
                "txn.fenced", txn_id=self._txn_id_for(self._epoch_n)
            )
            raise
        self.produced += len(self._buf)
        self._buf = []

    # -- the checkpoint-commit protocol ----------------------------------
    def prepare_commit(self) -> None:
        """Phase one, called AFTER the job drained its outputs and
        BEFORE the snapshot is captured: flush every buffered row into
        the open transaction and stamp its identity pending, so the
        snapshot about to be written carries it (state_dict). No rows
        this epoch => no transaction => nothing pending (empty
        transactions are never opened)."""
        self.flush()
        if (
            self.transactional
            and self._txn is not None
            and self._txn.in_txn
        ):
            self._pending = {
                "txn_id": self._txn.transactional_id,
                "producer_id": self._txn.producer_id,
                "producer_epoch": self._txn.producer_epoch,
                "n": self._epoch_n,
            }

    def commit_transaction(self) -> None:
        """Phase two, called only once the snapshot that will never
        re-emit the pending transaction's rows is durably on disk:
        EndTxn(commit), then advance to the next epoch's id. A crash
        BEFORE this call leaves the pending identity in the snapshot;
        restore resumes the commit (load_state_dict)."""
        if not self.transactional or self._pending is None:
            return
        p = self._pending
        try:
            self.client.end_txn(
                p["txn_id"], p["producer_id"], p["producer_epoch"],
                commit=True,
            )
        except ProducerFencedError:
            self.txn_fenced += 1
            self._txn_event("txn.fenced", txn_id=p["txn_id"])
            raise
        self.txn_commits += 1
        self._txn_event("txn.commit", txn_id=p["txn_id"])
        if self._txn is not None:
            self._txn.closed()
        self._txn = None  # next epoch inits a fresh id
        self._epoch_n = p["n"] + 1
        self._pending = None

    def abort_transaction(self) -> None:
        """Abort the open (uncommitted) transaction, if any — the
        discard half of the protocol; its rows were never visible."""
        if not self.transactional:
            return
        self._buf = []
        st, self._pending = self._txn, None
        if st is None or not st.in_txn:
            return
        try:
            self.client.end_txn(
                st.transactional_id, st.producer_id,
                st.producer_epoch, commit=False,
            )
        except ProducerFencedError:
            # a successor already owns the id: its InitProducerId
            # aborted this transaction for us — the outcome stands
            self.txn_fenced += 1
            self._txn_event("txn.fenced", txn_id=st.transactional_id)
        self.txn_aborts += 1
        self._txn_event("txn.abort", txn_id=st.transactional_id)
        st.closed()
        self._txn = None

    def txn_stats(self) -> dict:
        """Plain-builtins transactional account (health endpoints)."""
        return {
            "transactional_id": self.transactional_id,
            "epoch_n": self._epoch_n,
            "commits": self.txn_commits,
            "aborts": self.txn_aborts,
            "fenced": self.txn_fenced,
            "resumed": self.txn_resumed,
            "pending": self._pending is not None,
        }

    # -- checkpoint participation (plain builtins only) -------------------
    def state_dict(self) -> dict:
        d: dict = {
            "epoch_n": int(self._epoch_n),
            "produced": int(self.produced),
        }
        if self._pending is not None:
            d["pending"] = dict(self._pending)
        return d

    def load_state_dict(self, d: dict) -> None:
        self._epoch_n = int(d.get("epoch_n", 0))
        self.produced = int(d.get("produced", 0))
        if not self.transactional:
            return
        pending = d.get("pending")
        if pending:
            # RESUME the commit the snapshot promised: the crash
            # landed between the snapshot and EndTxn (commit now —
            # zero lost), or after it (the broker answers
            # INVALID_TXN_STATE: nothing open on that id — the commit
            # already happened, zero duplicated). Real brokers add a
            # third possibility — the transaction TIMED OUT and was
            # aborted, indistinguishable from committed here; the
            # fake broker never times out, and docs/fault_tolerance.md
            # carries the honest statement.
            try:
                self.client.end_txn(
                    pending["txn_id"],
                    pending["producer_id"],
                    pending["producer_epoch"],
                    commit=True,
                )
                self.txn_resumed += 1
                self._txn_event(
                    "txn.commit", txn_id=pending["txn_id"], resumed=True
                )
            except BrokerErrorResponse as e:
                if e.code != INVALID_TXN_STATE_CODE:
                    raise
            self.txn_commits += 1
            self._epoch_n = int(pending["n"]) + 1
        self._pending = None
        self._txn = None
        # eagerly claim the next epoch's id: fences the pre-crash
        # zombie NOW and aborts whatever it left open, instead of
        # waiting for the first post-restore row
        self._ensure_session()

    def close(self) -> None:
        """Flush (non-transactional) or abort-what's-open
        (transactional: visibility is the commit protocol's decision,
        never close()'s) and drop the connection."""
        if self.transactional:
            self.abort_transaction()
        else:
            self.flush()
        self.client.close()

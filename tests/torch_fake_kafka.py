"""In-process fake Kafka broker for protocol-level tests.

Two dialects, selected at construction:

* default ("modern", a >=2.x broker): answers ApiVersions (api 18) and
  advertises Produce up to v5 / Fetch up to v6 so the client's
  negotiation exercises real intersection (it implements 3 and 4);
  Produce v3 accepts v2 record batches (CRC32C validated, gzip
  inflated — a corrupt batch gets error code 2, CORRUPT_MESSAGE);
  Fetch v4 serves v2 batches re-encoded with ``fetch_codec`` (gzip by
  default) and — like a real broker — returns *whole batches*: a fetch
  offset landing mid-batch returns the batch containing it, and at
  least one batch is always returned regardless of max_bytes (KIP-74).
* ``legacy=True`` (a pre-0.10 broker): v0 apis only; an ApiVersions
  request slams the connection, which is exactly how old brokers
  answered and what the client's fallback-to-v0 path keys off.

Single node, in-memory logs. Batch boundaries are remembered per
produce/append call so whole-batch fetch semantics are honest.
``mangle_batch`` (a bytes->bytes hook applied to every served v2
batch) lets tests inject corruption or foreign codec flags on the
wire without touching the log.

Fault injection (``fault_hook``): a callable ``(api, seq) -> action``
consulted once per request, in arrival order (``seq`` is a
broker-lifetime request counter — deterministic schedules replay
exactly). Actions:

* ``None``             — serve normally
* ``"drop"``           — close the connection without answering (an
                         outage / crashed broker)
* ``"drop_mid_frame"`` — send the size header + half the response,
                         then close (the exact failure the client's
                         ``_read_frame`` sees as mid-frame close)
* ``"error"``          — answer Fetch/Produce/ListOffsets with the
                         transient NOT_LEADER_FOR_PARTITION code (6)
                         instead of data (other apis: like ``drop``)
* ``"corrupt"``        — serve THIS fetch's v2 batches mangled
                         (bit-flip => CRC32C mismatch); the log is
                         untouched, the next fetch is clean (other
                         apis: like ``drop``)
* ``"delay"``          — serve normally after ``fault_delay_s``
                         (default 2 ms; bounded, never a test clock)
* ``"fence"``          — bump the requesting producer's epoch
                         coordinator-side BEFORE handling, so this and
                         every later request from the old incarnation
                         answers INVALID_PRODUCER_EPOCH (the zombie-
                         producer shape; txn/produce apis only, other
                         apis: like ``drop``). Opt-in: NOT in
                         ``FaultSchedule.ACTIONS`` (seeded draws of
                         existing schedules must not shift).
* ``"abort_txn"``      — abort the requester's ongoing transaction
                         server-side (the transaction-timeout shape:
                         markers written, data becomes invisible to
                         read-committed) then handle the request
                         normally against the now-empty txn state.
                         Opt-in, like ``"fence"``.

Transaction coordinator (KIP-98, single node): InitProducerId (22)
grants ``(producer_id, epoch)`` per transactional id — re-running it
bumps the epoch, fences older holders, and aborts any transaction
they left open; AddPartitionsToTxn (24) registers marker targets;
EndTxn (26) appends a COMMIT/ABORT control batch to every registered
partition. Produce v3 validates the batch header's
producer_id/epoch/sequence: a stale epoch is fenced (47), the
expected next sequence appends, a re-send of the last appended batch
acks as DUPLICATE_SEQUENCE_NUMBER (46 — the client treats it as
success, closing the retry-duplicates hole), anything else is
OUT_OF_ORDER_SEQUENCE_NUMBER (45). Fetch v4 honors
``isolation_level``: read_committed (1) is capped at the last stable
offset and carries the aborted-transactions index for the served
range. Transactions never time out here — tests are exact where real
brokers are ambiguous (docs/fault_tolerance.md).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Tuple

from flink_siddhi_tpu_torch.connectors.kafka.protocol import (
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
    encode_api_versions_response,
)
from flink_siddhi_tpu_torch.connectors.kafka.records import (
    CorruptBatchError,
    decode_batch_meta,
    decode_record_set,
    encode_control_batch,
    encode_message_set,
    encode_record_batch,
)

ERR_CORRUPT_MESSAGE = 2
ERR_UNKNOWN_TOPIC = 3
ERR_NOT_LEADER = 6  # transient: the client's retry taxonomy retries it
ERR_OUT_OF_ORDER_SEQ = 45
ERR_DUPLICATE_SEQ = 46  # client's idempotent path treats as success
ERR_INVALID_EPOCH = 47  # fenced: fatal client-side
ERR_INVALID_TXN_STATE = 48
ERR_INVALID_PID_MAPPING = 49

# per-batch producer metadata for non-idempotent appends (the shape
# ``FakeBroker.append`` and legacy produce record per bound)
_PLAIN_META = {
    "pid": -1, "epoch": -1, "base_seq": -1, "txn": False, "control": None,
}

# what the modern dialect advertises (intentionally wider than the
# client implements: negotiation must intersect, not parrot)
MODERN_API_VERSIONS: Dict[int, Tuple[int, int]] = {
    API_PRODUCE: (0, 5),
    API_FETCH: (0, 6),
    API_LIST_OFFSETS: (0, 2),
    API_METADATA: (0, 5),
    API_VERSIONS: (0, 1),
    API_INIT_PRODUCER_ID: (0, 1),
    API_ADD_PARTITIONS_TO_TXN: (0, 1),
    API_END_TXN: (0, 1),
}


class FakeBroker:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        legacy: bool = False,
        fetch_codec: str = "gzip",
        api_versions: Optional[Dict[int, Tuple[int, int]]] = None,
    ) -> None:
        # (topic, partition) -> list of (ts, value)
        self.logs: Dict[Tuple[str, int], List] = {}
        # (topic, partition) -> sorted batch start offsets; batch i
        # covers [starts[i], starts[i+1]) (last runs to len(log))
        self.bounds: Dict[Tuple[str, int], List[int]] = {}
        # (topic, partition) -> per-bound producer metadata (parallel
        # to ``bounds``): pid/epoch/base_seq/txn/control — what a
        # served batch's header must carry back
        self.batch_meta: Dict[Tuple[str, int], List[dict]] = {}
        # -- transaction coordinator state (all under self._lock) ----
        self._next_pid = 1000
        # transactional_id -> {pid, epoch, state: "empty"|"ongoing",
        #                      partitions: set of (topic, partition)}
        self._txns: Dict[str, dict] = {}
        # producer_id -> current epoch (the fencing source of truth,
        # covers idempotent-only producers with no transactional id)
        self._pid_epoch: Dict[int, int] = {}
        # (topic, partition) -> {pid: (next_seq, last_base_seq,
        #                              last_base_off, epoch)}
        self._seqs: Dict[Tuple[str, int], Dict[int, tuple]] = {}
        # (topic, partition) -> {pid: first data offset of the OPEN
        # transaction} — what caps the last stable offset
        self._open_txn: Dict[Tuple[str, int], Dict[int, int]] = {}
        # (topic, partition) -> [(pid, first_offset, marker_offset)]
        # for every ABORTED transaction (the Fetch v4 index)
        self.aborted: Dict[Tuple[str, int], List[Tuple[int, int, int]]] = {}
        self.legacy = legacy
        self.fetch_codec = fetch_codec
        self.api_versions = dict(
            MODERN_API_VERSIONS if api_versions is None else api_versions
        )
        self.mangle_batch: Optional[Callable[[bytes], bytes]] = None
        # fault injection: (api, request_seq) -> action (see module
        # docstring); None = no faults. Request seq is broker-lifetime
        # and monotonic, so a seeded schedule replays deterministically.
        self.fault_hook: Optional[Callable[[int, int], Optional[str]]] = None
        self.fault_delay_s = 0.002
        self._req_seq = 0
        self._lock = threading.Lock()
        self._server = socket.create_server((host, port))
        self._server.settimeout(0.2)
        self.host, self.port = self._server.getsockname()[:2]
        self._closed = False
        threading.Thread(target=self._accept, daemon=True).start()

    @property
    def bootstrap(self) -> str:
        return f"{self.host}:{self.port}"

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        with self._lock:
            for p in range(partitions):
                self.logs.setdefault((topic, p), [])
                self.bounds.setdefault((topic, p), [])
                self.batch_meta.setdefault((topic, p), [])

    def append(self, topic: str, partition: int, values, ts_ms=0):
        """Append values as ONE batch (one bound) — a v4 fetch of any
        offset inside it returns the whole thing."""
        with self._lock:
            log = self.logs[(topic, partition)]
            self.bounds.setdefault((topic, partition), []).append(len(log))
            self.batch_meta.setdefault((topic, partition), []).append(
                dict(_PLAIN_META)
            )
            for v in values:
                if isinstance(v, str):
                    v = v.encode()
                log.append((ts_ms, v))

    def close(self) -> None:
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass

    # -- server loop ------------------------------------------------------
    def _accept(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._closed:
                head = b""
                while len(head) < 4:
                    chunk = conn.recv(4 - len(head))
                    if not chunk:
                        return
                    head += chunk
                (size,) = struct.unpack(">i", head)
                data = bytearray()
                while len(data) < size:
                    chunk = conn.recv(min(1 << 16, size - len(data)))
                    if not chunk:
                        return
                    data += chunk
                resp = self._handle(bytes(data))
                if resp is None:  # legacy broker / drop fault: hang up
                    return
                if isinstance(resp, tuple):  # ("partial", payload)
                    _, payload = resp
                    conn.sendall(
                        struct.pack(">i", len(payload))
                        + payload[: max(len(payload) // 2, 1)]
                    )
                    return  # close mid-frame
                conn.sendall(struct.pack(">i", len(resp)) + resp)
        finally:
            conn.close()

    # -- request dispatch -------------------------------------------------
    def _handle(self, data: bytes):
        r = Reader(data)
        api, version, corr = r.i16(), r.i16(), r.i32()
        r.string()  # client_id
        # fault injection happens here, per request, in arrival order
        fault = None
        if self.fault_hook is not None:
            with self._lock:
                seq = self._req_seq
                self._req_seq += 1
            fault = self.fault_hook(api, seq)
        if fault == "drop":
            return None
        if fault == "delay":
            time.sleep(self.fault_delay_s)
            fault = None
        _txn_apis = (
            API_PRODUCE, API_ADD_PARTITIONS_TO_TXN, API_END_TXN,
        )
        forced_err = 0
        corrupt = False
        fence = False
        abort_txn = False
        if fault == "error":
            if api in (
                API_FETCH, API_PRODUCE, API_LIST_OFFSETS,
                API_INIT_PRODUCER_ID, API_ADD_PARTITIONS_TO_TXN,
                API_END_TXN,
            ):
                forced_err = ERR_NOT_LEADER
            else:
                return None  # no error slot in these responses: drop
        elif fault == "corrupt":
            if api == API_FETCH:
                corrupt = True
            else:
                return None
        elif fault == "fence":
            if api in _txn_apis:
                fence = True
            else:
                return None  # no producer identity to fence: drop
        elif fault == "abort_txn":
            if api in _txn_apis:
                abort_txn = True
            else:
                return None
        w = Writer().i32(corr)
        if api == API_VERSIONS:
            if self.legacy:
                return None  # pre-0.10: slam the connection
            w.raw(encode_api_versions_response(self.api_versions))
        elif api == API_METADATA:
            self._metadata(r, w)
        elif api == API_LIST_OFFSETS:
            self._list_offsets(r, w, forced_err)
        elif api == API_FETCH:
            if version not in (0, 4):
                raise AssertionError(f"fake broker: Fetch v{version}")
            self._fetch(r, w, version, forced_err, corrupt)
        elif api == API_PRODUCE:
            if version not in (0, 3):
                raise AssertionError(f"fake broker: Produce v{version}")
            self._produce(r, w, version, forced_err, fence, abort_txn)
        elif api == API_INIT_PRODUCER_ID:
            if self.legacy:
                return None
            self._init_producer_id(r, w, forced_err)
        elif api == API_ADD_PARTITIONS_TO_TXN:
            if self.legacy:
                return None
            self._add_partitions_to_txn(
                r, w, forced_err, fence, abort_txn
            )
        elif api == API_END_TXN:
            if self.legacy:
                return None
            self._end_txn(r, w, forced_err, fence, abort_txn)
        else:
            if self.legacy:
                return None
            raise AssertionError(f"fake broker: unsupported api {api}")
        if fault == "drop_mid_frame":
            return ("partial", w.done())
        return w.done()

    def _metadata(self, r: Reader, w: Writer) -> None:
        n = r.i32()
        topics = [r.string() for _ in range(n)]
        with self._lock:
            if not topics:
                topics = sorted({t for t, _ in self.logs})
            w.i32(1).i32(0).string(self.host).i32(self.port)
            w.i32(len(topics))
            for t in topics:
                parts = sorted(p for (tt, p) in self.logs if tt == t)
                w.i16(0 if parts else ERR_UNKNOWN_TOPIC).string(t)
                w.i32(len(parts))
                for p in parts:
                    w.i16(0).i32(p).i32(0)
                    w.i32(1).i32(0)  # replicas [0]
                    w.i32(1).i32(0)  # isr [0]

    def _list_offsets(
        self, r: Reader, w: Writer, forced_err: int = 0
    ) -> None:
        r.i32()  # replica
        w.i32(r_topics := r.i32())
        for _ in range(r_topics):
            t = r.string()
            np_ = r.i32()
            w.string(t).i32(np_)
            for _ in range(np_):
                pid, time_, _maxn = r.i32(), r.i64(), r.i32()
                if forced_err:
                    w.i32(pid).i16(forced_err).i32(0)
                    continue
                with self._lock:
                    log = self.logs.get((t, pid))
                if log is None:
                    w.i32(pid).i16(ERR_UNKNOWN_TOPIC).i32(0)
                    continue
                off = 0 if time_ == -2 else len(log)
                w.i32(pid).i16(0).i32(1).i64(off)

    # -- fetch ------------------------------------------------------------
    def _fetch(
        self, r: Reader, w: Writer, version: int,
        forced_err: int = 0, corrupt: bool = False,
    ) -> None:
        r.i32(), r.i32(), r.i32()  # replica, max_wait, min_bytes
        isolation = 0
        if version >= 4:
            r.i32()  # total max_bytes
            isolation = r.i8()  # 0 = read_uncommitted, 1 = read_committed
            w.i32(0)  # throttle_time_ms
        nt = r.i32()
        w.i32(nt)
        for _ in range(nt):
            t = r.string()
            np_ = r.i32()
            w.string(t).i32(np_)
            for _ in range(np_):
                pid, off, maxb = r.i32(), r.i64(), r.i32()
                with self._lock:
                    log = list(self.logs.get((t, pid), ()))
                    bounds = list(self.bounds.get((t, pid), ()))
                    meta = list(self.batch_meta.get((t, pid), ()))
                    open_firsts = list(
                        self._open_txn.get((t, pid), {}).values()
                    )
                    aborted = list(self.aborted.get((t, pid), ()))
                hw = len(log)
                # last stable offset: everything below it is decided
                # (committed or aborted-with-marker); an OPEN
                # transaction's first data offset pins it down
                lso = min(open_firsts) if open_firsts else hw
                if forced_err:
                    w.i32(pid).i16(forced_err).i64(hw)
                    if version >= 4:
                        w.i64(hw).i32(0)
                    w.bytes_(b"")
                    continue
                if version >= 4:
                    cap = lso if isolation == 1 else hw
                    rset, end = self._serve_batches(
                        log, bounds, meta, off, maxb,
                        corrupt=corrupt, cap=cap,
                    )
                    w.i32(pid).i16(0).i64(hw)
                    w.i64(lso if isolation == 1 else hw)
                    if isolation == 1:
                        # aborted transactions overlapping the served
                        # range: first data offset <= served end and
                        # marker at/after the fetch offset (KIP-98's
                        # index; the client clears each pid at its
                        # control batch)
                        rel = [
                            (apid, first)
                            for apid, first, marker in aborted
                            if first < end and marker >= off
                        ]
                        w.i32(len(rel))
                        for apid, first in rel:
                            w.i64(apid).i64(first)
                    else:
                        w.i32(0)  # aborted_transactions
                    w.bytes_(rset)
                else:
                    rset = self._serve_messages(log, off, maxb)
                    w.i32(pid).i16(0).i64(hw).bytes_(rset)

    @staticmethod
    def _serve_messages(log, off: int, maxb: int) -> bytes:
        """v0 dialect: one legacy message per record, byte-capped."""
        mset = b""
        o = off
        while o < len(log) and len(mset) < maxb:
            ts, v = log[o]
            one = encode_message_set([v], ts_ms=ts)
            # stamp the real offset into the entry header
            one = struct.pack(">q", o) + one[8:]
            mset += one
            o += 1
        return mset

    def _serve_batches(
        self, log, bounds, meta, off: int, maxb: int,
        corrupt: bool = False, cap: Optional[int] = None,
    ) -> Tuple[bytes, int]:
        """v4 dialect: whole v2 batches, starting with the batch that
        CONTAINS the fetch offset; always at least one batch. Returns
        ``(record_set, end_offset_served)``. Batches are re-encoded
        with their recorded producer metadata (id/epoch/sequence, the
        transactional bit) so a consumer can attribute each batch to
        its transaction; control bounds re-encode as real control
        batches. ``cap`` (the last stable offset under
        read_committed) stops serving at the first batch that starts
        at or beyond it. ``corrupt=True`` (one fetch's fault action)
        flips a payload bit in every served batch — CRC32C fails
        client-side, the log itself stays clean."""
        if off >= len(log) or not bounds:
            return b"", off
        from flink_siddhi_tpu_torch.connectors.kafka.codecs import codec_id

        if cap is None:
            cap = len(log)
        i = max(bisect_right(bounds, off) - 1, 0)
        out = b""
        served_end = off
        while i < len(bounds) and (not out or len(out) < maxb):
            start = bounds[i]
            if start >= cap:
                break  # open-transaction data: above the LSO
            end = bounds[i + 1] if i + 1 < len(bounds) else len(log)
            m = meta[i] if i < len(meta) else _PLAIN_META
            if m["control"] is not None:
                batch = encode_control_batch(
                    start,
                    m["pid"],
                    m["epoch"],
                    commit=(m["control"] == "commit"),
                    ts_ms=log[start][0],
                )
            else:
                entries = [(ts, None, v) for ts, v in log[start:end]]
                batch = encode_record_batch(
                    entries,
                    base_offset=start,
                    codec=codec_id(self.fetch_codec),
                    producer_id=m["pid"],
                    producer_epoch=m["epoch"],
                    base_sequence=m["base_seq"],
                    transactional=m["txn"],
                )
            if self.mangle_batch is not None:
                batch = self.mangle_batch(batch)
            if corrupt:
                b = bytearray(batch)
                b[-1] ^= 0x04  # payload bit: breaks the batch CRC32C
                batch = bytes(b)
            out += batch
            served_end = end
            i += 1
        return out, served_end

    # -- produce ----------------------------------------------------------
    def _produce(
        self, r: Reader, w: Writer, version: int, forced_err: int = 0,
        fence: bool = False, abort_txn: bool = False,
    ) -> None:
        txn_id = None
        if version >= 3:
            txn_id = r.string()  # transactional_id
        r.i16(), r.i32()  # acks, timeout
        nt = r.i32()
        w.i32(nt)
        for _ in range(nt):
            t = r.string()
            np_ = r.i32()
            w.string(t).i32(np_)
            for _ in range(np_):
                pid = r.i32()
                rset = r.bytes_() or b""
                if forced_err:
                    # transient refusal: NOTHING is appended — the
                    # client's retry re-sends the whole batch (same
                    # base_sequence, so the idempotent path dedupes)
                    w.i32(pid).i16(forced_err).i64(-1)
                    if version >= 2:
                        w.i64(-1)
                    continue
                try:
                    # magic sits at byte 16 in BOTH wire formats;
                    # only v2 batches carry producer metadata
                    is_v2 = len(rset) > 16 and rset[16] >= 2
                    bm = decode_batch_meta(rset) if is_v2 else None
                    msgs = decode_record_set(rset)
                    err = 0
                except CorruptBatchError:
                    bm, msgs, err = None, [], ERR_CORRUPT_MESSAGE
                with self._lock:
                    if fence and bm is not None and bm["producer_id"] >= 0:
                        self._fence_pid_locked(bm["producer_id"])
                    if abort_txn and txn_id is not None:
                        self._abort_ongoing_locked(txn_id)
                    base = len(self.logs.setdefault((t, pid), []))
                    if err == 0 and bm is not None:
                        err, base = self._validate_append_locked(
                            t, pid, txn_id, bm, msgs
                        )
                    elif err == 0 and msgs:
                        # batch-less entries (legacy v0 payloads in a
                        # v3 request don't occur; defensive)
                        self._append_locked(t, pid, msgs, _PLAIN_META)
                w.i32(pid).i16(err).i64(base)
                if version >= 2:
                    w.i64(-1)  # log_append_time
        if version >= 1:
            w.i32(0)  # throttle_time_ms

    def _append_locked(self, t, pid, msgs, meta: dict) -> int:
        """Append one decoded batch as one bound; -> base offset."""
        log = self.logs.setdefault((t, pid), [])
        base = len(log)
        if msgs:
            self.bounds.setdefault((t, pid), []).append(base)
            self.batch_meta.setdefault((t, pid), []).append(dict(meta))
            for _off, ts, _k, v in msgs:
                log.append((ts or 0, v))
        return base

    def _validate_append_locked(
        self, t, pid, txn_id, bm: dict, msgs
    ) -> Tuple[int, int]:
        """KIP-98 produce-side validation -> (error_code, base_offset).

        Epoch fencing first (a zombie's data must never land), then
        sequence idempotence (expected next appends; a re-send of the
        LAST appended batch acks as DUPLICATE_SEQUENCE_NUMBER with its
        original base offset — success client-side; anything else is
        OUT_OF_ORDER), then transaction membership (data for a
        transaction that is not ongoing on this partition is
        INVALID_TXN_STATE)."""
        ppid = bm["producer_id"]
        epoch = bm["producer_epoch"]
        base_seq = bm["base_sequence"]
        key = (t, pid)
        if ppid < 0:
            # non-idempotent classic batch
            if bm["transactional"]:
                return ERR_INVALID_TXN_STATE, -1
            return 0, self._append_locked(t, pid, msgs, _PLAIN_META)
        cur = self._pid_epoch.get(ppid)
        if cur is None:
            return ERR_INVALID_PID_MAPPING, -1
        if epoch != cur:
            return ERR_INVALID_EPOCH, -1
        entry = self._txns.get(txn_id) if txn_id is not None else None
        if bm["transactional"]:
            if (
                entry is None
                or entry["pid"] != ppid
                or entry["state"] != "ongoing"
                or key not in entry["partitions"]
            ):
                return ERR_INVALID_TXN_STATE, -1
        st = self._seqs.setdefault(key, {}).get(ppid)
        if st is not None and st[3] == epoch:
            next_seq, last_base_seq, last_base_off, _ = st
            if base_seq == last_base_seq:
                # the retry-after-append shape: already holding this
                # batch, ack it without a second append
                return ERR_DUPLICATE_SEQ, last_base_off
            if base_seq != next_seq:
                return ERR_OUT_OF_ORDER_SEQ, -1
        else:
            # new producer session on this partition: sequences
            # restart at 0 (the epoch scopes them)
            if base_seq != 0:
                return ERR_OUT_OF_ORDER_SEQ, -1
        meta = {
            "pid": ppid,
            "epoch": epoch,
            "base_seq": base_seq,
            "txn": bm["transactional"],
            "control": None,
        }
        base = self._append_locked(t, pid, msgs, meta)
        self._seqs[key][ppid] = (
            base_seq + len(msgs), base_seq, base, epoch
        )
        if bm["transactional"]:
            self._open_txn.setdefault(key, {}).setdefault(ppid, base)
        return 0, base

    # -- transaction coordinator ------------------------------------------
    def _fence_pid_locked(self, ppid: int) -> None:
        """Server-side epoch bump: the current holder of ``ppid``
        becomes a zombie (its next request answers 47)."""
        if ppid in self._pid_epoch:
            self._pid_epoch[ppid] += 1
            for entry in self._txns.values():
                if entry["pid"] == ppid:
                    entry["epoch"] = self._pid_epoch[ppid]

    def _abort_ongoing_locked(self, txn_id: str) -> None:
        """Abort ``txn_id``'s ongoing transaction (markers written,
        aborted index updated) — the transaction-timeout shape."""
        entry = self._txns.get(txn_id)
        if entry is not None and entry["state"] == "ongoing":
            self._complete_txn_locked(entry, commit=False)

    def _complete_txn_locked(self, entry: dict, commit: bool) -> None:
        """Write a COMMIT/ABORT control batch to every partition the
        transaction registered, update the aborted index, close the
        transaction server-side."""
        verdict = "commit" if commit else "abort"
        for key in sorted(entry["partitions"]):
            log = self.logs.setdefault(key, [])
            marker_off = len(log)
            self.bounds.setdefault(key, []).append(marker_off)
            self.batch_meta.setdefault(key, []).append({
                "pid": entry["pid"],
                "epoch": entry["epoch"],
                "base_seq": -1,
                "txn": True,
                "control": verdict,
            })
            log.append((0, b""))  # the marker occupies one offset
            first = self._open_txn.get(key, {}).pop(entry["pid"], None)
            if not commit and first is not None:
                self.aborted.setdefault(key, []).append(
                    (entry["pid"], first, marker_off)
                )
        entry["state"] = "empty"
        entry["partitions"] = set()

    def _init_producer_id(
        self, r: Reader, w: Writer, forced_err: int = 0
    ) -> None:
        txn_id = r.string()
        r.i32()  # transaction_timeout_ms (never enforced here)
        if forced_err:
            w.i32(0).i16(forced_err).i64(-1).i16(-1)
            return
        with self._lock:
            if txn_id is None:
                # idempotence-only producer: fresh pid, epoch 0
                ppid, epoch = self._next_pid, 0
                self._next_pid += 1
            else:
                entry = self._txns.get(txn_id)
                if entry is None:
                    entry = {
                        "pid": self._next_pid,
                        "epoch": 0,
                        "state": "empty",
                        "partitions": set(),
                    }
                    self._next_pid += 1
                    self._txns[txn_id] = entry
                else:
                    # the fencing moment: older holders of this id
                    # are zombies from here on, and whatever they
                    # left open is aborted
                    if entry["state"] == "ongoing":
                        self._complete_txn_locked(entry, commit=False)
                    entry["epoch"] += 1
                ppid, epoch = entry["pid"], entry["epoch"]
            self._pid_epoch[ppid] = epoch
        w.i32(0).i16(0).i64(ppid).i16(epoch)

    def _add_partitions_to_txn(
        self, r: Reader, w: Writer, forced_err: int = 0,
        fence: bool = False, abort_txn: bool = False,
    ) -> None:
        txn_id = r.string()
        ppid = r.i64()
        epoch = r.i16()
        topics = []
        for _ in range(r.i32()):
            t = r.string()
            parts = [r.i32() for _ in range(r.i32())]
            topics.append((t, parts))
        with self._lock:
            if fence:
                self._fence_pid_locked(ppid)
            if abort_txn and txn_id is not None:
                self._abort_ongoing_locked(txn_id)
            entry = self._txns.get(txn_id)
            if forced_err:
                err = forced_err
            elif entry is None or entry["pid"] != ppid:
                err = ERR_INVALID_PID_MAPPING
            elif epoch != entry["epoch"]:
                err = ERR_INVALID_EPOCH
            else:
                err = 0
                entry["state"] = "ongoing"
                for t, parts in topics:
                    for p in parts:
                        entry["partitions"].add((t, p))
                        self.logs.setdefault((t, p), [])
        w.i32(0).i32(len(topics))
        for t, parts in topics:
            w.string(t).i32(len(parts))
            for p in parts:
                w.i32(p).i16(err)

    def _end_txn(
        self, r: Reader, w: Writer, forced_err: int = 0,
        fence: bool = False, abort_txn: bool = False,
    ) -> None:
        txn_id = r.string()
        ppid = r.i64()
        epoch = r.i16()
        commit = bool(r.i8())
        with self._lock:
            if fence:
                self._fence_pid_locked(ppid)
            if abort_txn and txn_id is not None:
                self._abort_ongoing_locked(txn_id)
            entry = self._txns.get(txn_id)
            if forced_err:
                err = forced_err
            elif entry is None or entry["pid"] != ppid:
                err = ERR_INVALID_PID_MAPPING
            elif epoch != entry["epoch"]:
                err = ERR_INVALID_EPOCH
            elif entry["state"] != "ongoing":
                # nothing open: for a RESUMED commit this is the
                # already-completed signal (see runtime/kafka.py)
                err = ERR_INVALID_TXN_STATE
            else:
                err = 0
                self._complete_txn_locked(entry, commit=commit)
        w.i32(0).i16(err)


def read_topic(
    bootstrap: str,
    topic: str,
    partition: int = 0,
    committed: bool = True,
) -> List[bytes]:
    """Drain one partition through the REAL client and return its data
    record values — the external observer the exactly-once claims are
    asserted against. ``committed=True`` consumes read_committed
    (isolation 1: capped at the LSO, aborted transactions filtered by
    the client from the wire index); ``committed=False`` consumes
    read_uncommitted, where aborted/open transactional data is still
    visible. Control-batch and aborted-record offsets advance without
    contributing values. Assumes a quiescent broker (post-run): stops
    at the first fetch that makes no progress."""
    from flink_siddhi_tpu_torch.runtime.kafka import KafkaClient

    host, _, port = bootstrap.partition(":")
    client = KafkaClient(host, int(port or 9092))
    try:
        off = client.list_offsets(topic, [partition], -2)[partition]
        values: List[bytes] = []
        while True:
            res = client.fetch(
                topic, {partition: off},
                isolation=1 if committed else 0,
            )
            _hw, records, _raw = res[partition]
            progressed = False
            for o, _ts, _k, v in records:
                if o < off:
                    continue  # whole-batch resend below the position
                if v is not None:
                    values.append(v)
                off = o + 1
                progressed = True
            if not progressed:
                return values
    finally:
        client.close()

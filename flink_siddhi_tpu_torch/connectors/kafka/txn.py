"""KIP-98 transactional producer protocol: wire codecs + client state.

Three request/response pairs close the exactly-once gap between the
engine's internal commit protocol and an external consumer:

* **InitProducerId** (api 22) — maps a ``transactional_id`` to a
  ``(producer_id, epoch)``. Re-running it on the same id bumps the
  epoch and FENCES every older holder: their next transactional
  request gets INVALID_PRODUCER_EPOCH (surfaced as
  ``ProducerFencedError``, fatal). It also aborts any transaction the
  previous incarnation left open — which is exactly what a restarted
  job needs a zombie's half-written suffix to become: aborted, hence
  invisible to read-committed consumers.
* **AddPartitionsToTxn** (api 24) — registers a partition with the
  ongoing transaction before the first produce touches it, so the
  coordinator knows where commit/abort markers must be written.
* **EndTxn** (api 26) — two-phase commit's second phase: the
  coordinator writes a control batch (commit or abort marker) into
  every registered partition and closes the transaction.

Produce-side idempotence rides the magic-2 batch header: each batch
carries ``(producer_id, epoch, base_sequence)``; the broker appends
only the expected next sequence, acknowledges an already-appended
re-send as DUPLICATE_SEQUENCE_NUMBER (success — the retry-duplicates
caveat of the plain path disappears), and rejects gaps as
OUT_OF_ORDER_SEQUENCE_NUMBER (fatal).

This module is pure wire format + client-side bookkeeping
(``TransactionState``); the transport (connection, retry, dialect
negotiation) lives in ``runtime/kafka.py``, which drives these codecs
through the same retrying call path every other api uses. Commit
TIMING — when a transaction opens and when EndTxn(commit) fires — is
owned by the checkpoint protocol (``runtime/supervisor.py``): one
transaction per checkpoint epoch, committed only after the snapshot
that will never re-emit its rows is durably on disk.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .errors import broker_error
from .protocol import Reader, Writer

__all__ = [
    "TransactionState",
    "encode_init_producer_id_request",
    "decode_init_producer_id_response",
    "encode_add_partitions_request",
    "decode_add_partitions_response",
    "encode_end_txn_request",
    "decode_end_txn_response",
]

#: Transaction timeout handed to InitProducerId. Real brokers abort a
#: transaction left open longer than this — the source of the one
#: honest ambiguity in crash recovery (a resumed commit may find the
#: transaction timed out and aborted; see docs/fault_tolerance.md).
#: The fake broker never times transactions out, so tests are exact.
DEFAULT_TXN_TIMEOUT_MS = 60_000


# -- wire codecs (all v0) ---------------------------------------------------

def encode_init_producer_id_request(
    transactional_id: str, txn_timeout_ms: int = DEFAULT_TXN_TIMEOUT_MS
) -> bytes:
    """InitProducerId v0 body: transactional_id, transaction timeout."""
    return (
        Writer().string(transactional_id).i32(int(txn_timeout_ms)).done()
    )


def decode_init_producer_id_response(r: Reader) -> Tuple[int, int]:
    """-> (producer_id, producer_epoch); raises on broker error."""
    r.i32()  # throttle_time_ms
    err = r.i16()
    pid = r.i64()
    epoch = r.i16()
    if err:
        raise broker_error(
            f"InitProducerId: broker error {err}", err, api="init_producer_id"
        )
    return pid, epoch


def encode_add_partitions_request(
    transactional_id: str,
    producer_id: int,
    producer_epoch: int,
    partitions: Sequence[Tuple[str, int]],
) -> bytes:
    """AddPartitionsToTxn v0 body; ``partitions``: (topic, partition)."""
    by_topic: Dict[str, List[int]] = {}
    for topic, part in partitions:
        by_topic.setdefault(topic, []).append(int(part))
    w = (
        Writer()
        .string(transactional_id)
        .i64(int(producer_id))
        .i16(int(producer_epoch))
        .i32(len(by_topic))
    )
    for topic in sorted(by_topic):
        w.string(topic).i32(len(by_topic[topic]))
        for part in by_topic[topic]:
            w.i32(part)
    return w.done()


def decode_add_partitions_response(r: Reader) -> None:
    """Raises on the first per-partition error; returns None on clean."""
    r.i32()  # throttle_time_ms
    for _ in range(r.i32()):
        topic = r.string()
        for _ in range(r.i32()):
            part = r.i32()
            err = r.i16()
            if err:
                raise broker_error(
                    f"AddPartitionsToTxn {topic}[{part}]: broker "
                    f"error {err}",
                    err,
                    api="add_partitions_to_txn",
                )


def encode_end_txn_request(
    transactional_id: str,
    producer_id: int,
    producer_epoch: int,
    commit: bool,
) -> bytes:
    """EndTxn v0 body: the commit/abort decision for the open txn."""
    return (
        Writer()
        .string(transactional_id)
        .i64(int(producer_id))
        .i16(int(producer_epoch))
        .i8(1 if commit else 0)
        .done()
    )


def decode_end_txn_response(r: Reader) -> None:
    r.i32()  # throttle_time_ms
    err = r.i16()
    if err:
        raise broker_error(
            f"EndTxn: broker error {err}", err, api="end_txn"
        )


# -- client-side transaction state -----------------------------------------

class TransactionState:
    """Client-side bookkeeping for ONE producer session: the
    ``(producer_id, epoch)`` granted by InitProducerId, per-partition
    produce sequences, and the partition set of the ongoing
    transaction.

    Pure state — no I/O. The runtime sink drives it: ``open()`` after
    InitProducerId, ``needs_partition()``/``partition_added()`` around
    AddPartitionsToTxn, ``next_sequence()``/``advance()`` around each
    produce, ``closed()`` after EndTxn. Serializes to plain builtins
    (``to_dict``/``from_dict``) so a checkpoint can carry the pending
    transaction's identity through the safelist unpickler."""

    def __init__(
        self,
        transactional_id: str,
        producer_id: int = -1,
        producer_epoch: int = -1,
    ) -> None:
        self.transactional_id = str(transactional_id)
        self.producer_id = int(producer_id)
        self.producer_epoch = int(producer_epoch)
        #: next base_sequence per (topic, partition) — per KIP-98 the
        #: sequence restarts at 0 for every new producer session
        #: (every InitProducerId bumps the epoch, which scopes them)
        self.sequences: Dict[Tuple[str, int], int] = {}
        #: partitions registered with the ongoing transaction
        self.txn_partitions: set = set()
        self.in_txn = False

    def open(self, producer_id: int, producer_epoch: int) -> None:
        """A fresh producer session from InitProducerId."""
        self.producer_id = int(producer_id)
        self.producer_epoch = int(producer_epoch)
        self.sequences.clear()
        self.txn_partitions.clear()
        self.in_txn = False

    def begin(self) -> None:
        if self.producer_id < 0:
            raise RuntimeError(
                "begin() before InitProducerId granted a producer id"
            )
        self.in_txn = True
        self.txn_partitions.clear()

    def needs_partition(self, topic: str, partition: int) -> bool:
        return (topic, int(partition)) not in self.txn_partitions

    def partition_added(self, topic: str, partition: int) -> None:
        self.txn_partitions.add((topic, int(partition)))

    def next_sequence(self, topic: str, partition: int) -> int:
        return self.sequences.get((topic, int(partition)), 0)

    def advance(self, topic: str, partition: int, n_records: int) -> None:
        key = (topic, int(partition))
        self.sequences[key] = self.sequences.get(key, 0) + int(n_records)

    def closed(self) -> None:
        """EndTxn completed (either verdict): no transaction is open."""
        self.in_txn = False
        self.txn_partitions.clear()

    # -- checkpoint support (plain builtins only) --------------------------
    def to_dict(self) -> dict:
        return {
            "transactional_id": self.transactional_id,
            "producer_id": self.producer_id,
            "producer_epoch": self.producer_epoch,
            "in_txn": bool(self.in_txn),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TransactionState":
        st = cls(
            d["transactional_id"],
            producer_id=int(d.get("producer_id", -1)),
            producer_epoch=int(d.get("producer_epoch", -1)),
        )
        st.in_txn = bool(d.get("in_txn", False))
        return st

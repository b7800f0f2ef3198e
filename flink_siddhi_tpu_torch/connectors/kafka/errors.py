"""One error hierarchy for the whole Kafka stack, with an explicit
retryable-vs-fatal taxonomy.

``except KafkaError`` at the engine boundary catches every failure
this layer can raise — wire-format corruption, codec gaps, protocol
parse errors, broker-reported errors and transport failures alike.
Subclasses exist where a caller needs to *distinguish*:
``BrokerClosedError`` (the broker accepted the connection and then
hung up — the pre-0.10 answer to ApiVersions, and the only signal
that may legitimately downgrade the dialect to v0) versus everything
else (which must propagate, never silently downgrade).

Taxonomy: every error carries a ``retryable`` flag, declared at the
class site (or computed from the broker error code), so retry policy
and error semantics live in one place:

* **retryable** — a retry against the same broker can legitimately
  succeed: transport failures (``BrokerIOError``, ``BrokerClosedError``
  — the connection is re-established and API versions re-negotiated),
  wire corruption (``CorruptBatchError`` — a re-fetch of the same
  offset may produce clean bytes; on-the-wire corruption is
  indistinguishable from a flaky link), and the broker error codes
  Kafka itself marks retriable (leader elections, metadata
  propagation, timeouts — ``RETRYABLE_BROKER_CODES``).
* **fatal** — retrying cannot change the outcome: protocol parse
  errors (``ProtocolError`` — the dialect itself is broken),
  unsupported codecs, offset-out-of-range, oversized messages,
  authorization failures. These propagate immediately.

Produce retries on the PLAIN (non-transactional) path are
**at-least-once**: a request that failed after the broker appended it
is re-sent on retry with no sequence number to dedupe against.
The transactional path (connectors/kafka/txn.py + a ``KafkaSink``
built with ``transactional_id=...``) closes that hole: batches carry
producer_id/epoch/sequence, a re-sent batch the broker already holds
is acknowledged as ``DUPLICATE_SEQUENCE_NUMBER`` (success, not a
duplicate append), and transactions commit exactly when the
supervisor's checkpoint-commit protocol commits. The old caveat
still applies to sinks WITHOUT a transactional id.

One transactional code is deliberately fatal-with-its-own-class:
``ProducerFencedError`` (INVALID_PRODUCER_EPOCH). A fenced producer
is a zombie — a newer incarnation holds its transactional id — and a
fenced producer that retries is exactly the split-brain duplicate
writer the epoch exists to prevent. It must crash, never retry.
"""

from __future__ import annotations


class KafkaError(RuntimeError):
    """Base for every error raised by the Kafka connector stack."""

    #: Whether a retry of the failed call can legitimately succeed.
    #: Class-level default; subclasses override (or compute from a
    #: broker error code). ``is_retryable`` is the single reader.
    retryable: bool = False


class BrokerClosedError(KafkaError):
    """The broker closed an established connection mid-exchange."""

    retryable = True


class BrokerIOError(KafkaError):
    """Transport-level failure (socket error, timeout, correlation
    desync). The connection is torn down; a retry reconnects and
    re-runs ApiVersions negotiation."""

    retryable = True


# Broker error codes Kafka's own Errors table marks retriable: another
# attempt against the (possibly re-elected) broker can succeed.
RETRYABLE_BROKER_CODES = {
    2: "CORRUPT_MESSAGE",  # re-fetch may produce clean bytes
    3: "UNKNOWN_TOPIC_OR_PARTITION",  # metadata still propagating
    5: "LEADER_NOT_AVAILABLE",
    6: "NOT_LEADER_FOR_PARTITION",
    7: "REQUEST_TIMED_OUT",
    9: "REPLICA_NOT_AVAILABLE",
    13: "NETWORK_EXCEPTION",
    14: "COORDINATOR_LOAD_IN_PROGRESS",
    15: "COORDINATOR_NOT_AVAILABLE",
    16: "NOT_COORDINATOR",
    19: "NOT_ENOUGH_REPLICAS",
    20: "NOT_ENOUGH_REPLICAS_AFTER_APPEND",
    51: "CONCURRENT_TRANSACTIONS",  # prior txn still completing
}

# Named fatal codes (for messages only — ANY code not in the retryable
# table is treated as fatal, named or not). The transactional block
# (45..53) is fatal by design: an out-of-order sequence means the
# idempotence window was lost, a stale epoch means this producer is a
# fenced zombie, a state-machine violation means the caller's commit
# protocol is broken — none of these can succeed on retry.
FATAL_BROKER_CODES = {
    1: "OFFSET_OUT_OF_RANGE",
    4: "INVALID_FETCH_SIZE",
    10: "MESSAGE_TOO_LARGE",
    17: "INVALID_TOPIC_EXCEPTION",
    18: "RECORD_LIST_TOO_LARGE",
    29: "TOPIC_AUTHORIZATION_FAILED",
    30: "GROUP_AUTHORIZATION_FAILED",
    31: "CLUSTER_AUTHORIZATION_FAILED",
    45: "OUT_OF_ORDER_SEQUENCE_NUMBER",
    46: "DUPLICATE_SEQUENCE_NUMBER",  # produce path treats as success
    47: "INVALID_PRODUCER_EPOCH",  # raised as ProducerFencedError
    48: "INVALID_TXN_STATE",
    49: "INVALID_PRODUCER_ID_MAPPING",
    53: "TRANSACTIONAL_ID_AUTHORIZATION_FAILED",
}

#: INVALID_PRODUCER_EPOCH — the fencing code (KIP-98).
PRODUCER_FENCED_CODE = 47
#: DUPLICATE_SEQUENCE_NUMBER — the broker already holds this batch;
#: the idempotent produce path treats it as a successful append.
DUPLICATE_SEQUENCE_CODE = 46
#: INVALID_TXN_STATE — on a resumed EndTxn(commit) this means the
#: commit already happened before the crash (see runtime/kafka.py).
INVALID_TXN_STATE_CODE = 48


def broker_code_name(code: int) -> str:
    return (
        RETRYABLE_BROKER_CODES.get(code)
        or FATAL_BROKER_CODES.get(code)
        or f"error {code}"
    )


class BrokerErrorResponse(KafkaError):
    """The broker answered the request with a non-zero error code."""

    def __init__(self, message: str, code: int, api: str = "") -> None:
        super().__init__(message)
        self.code = int(code)
        self.api = api

    @property
    def retryable(self) -> bool:  # type: ignore[override]
        return self.code in RETRYABLE_BROKER_CODES


class ProducerFencedError(BrokerErrorResponse):
    """This producer's (transactional_id, epoch) was superseded —
    a newer incarnation ran InitProducerId on the same id. FATAL:
    retrying from a fenced producer is the split-brain duplicate
    writer the epoch fence exists to prevent. The only correct
    response is to stop producing and let the current incarnation
    own the id."""

    #: Shadows BrokerErrorResponse's computed property: fenced is
    #: fatal no matter what any retry table says.
    retryable = False

    def __init__(self, message: str, api: str = "") -> None:
        super().__init__(message, code=PRODUCER_FENCED_CODE, api=api)


def broker_error(message: str, code: int, api: str = "") -> BrokerErrorResponse:
    """Build the right exception for a broker error code — the single
    place the fencing code is promoted to its own class."""
    if int(code) == PRODUCER_FENCED_CODE:
        return ProducerFencedError(message, api=api)
    return BrokerErrorResponse(message, code=code, api=api)


def is_retryable(exc: BaseException) -> bool:
    """The taxonomy's single reader: whether a retry of the failed
    call can legitimately succeed. Non-Kafka exceptions are fatal."""
    return bool(getattr(exc, "retryable", False))


def is_connection_error(exc: BaseException) -> bool:
    """Whether the failure invalidated the connection itself — the
    retry must reconnect AND re-run ApiVersions negotiation (a pinned
    dialect must not outlive the connection it was negotiated on)."""
    return isinstance(exc, (BrokerClosedError, BrokerIOError))

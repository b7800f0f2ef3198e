"""Kafka wire-format layer: everything between raw TCP frames and
(offset, timestamp, key, value) tuples.

Modules:

* ``varint``   — zigzag varint/varlong encode/decode (v2 records)
* ``crc32c``   — pure-Python Castagnoli CRC (RFC 3720 vectors in tests)
* ``codecs``   — compression-codec registry (gzip via stdlib; snappy/
  lz4/zstd are loud rejections naming the codec)
* ``records``  — magic 0/1 message sets AND magic 2 record batches,
  with batch-level CRC32C validated on every decode
* ``protocol`` — request/response primitives, api keys, and
  ApiVersions negotiation (pick Fetch/Produce versions per broker,
  fall back to the v0 dialect for pre-0.10 brokers)
* ``errors``   — one KafkaError hierarchy with the retryable-vs-fatal
  taxonomy (``is_retryable`` / ``is_connection_error``), including
  the transactional codes and ``ProducerFencedError``
* ``retry``    — RetryPolicy: exponential backoff, deterministic
  seeded jitter, bounded attempts, per-call deadline
* ``txn``      — KIP-98 transactional request/response codecs
  (InitProducerId / AddPartitionsToTxn / EndTxn) and the
  ``TransactionState`` sequence/partition tracker

``runtime/kafka.py`` composes these into the engine's KafkaSource /
KafkaSink; tests/fake_kafka.py composes the same modules into the
in-process broker, so every byte both sides exchange goes through one
implementation of the format.
"""

from .codecs import (  # noqa: F401
    CODEC_GZIP,
    CODEC_NONE,
    UnsupportedCodecError,
    codec_name,
    compress,
    decompress,
)
from .crc32c import crc32c  # noqa: F401
from .errors import (  # noqa: F401
    BrokerClosedError,
    BrokerErrorResponse,
    BrokerIOError,
    KafkaError,
    ProducerFencedError,
    RETRYABLE_BROKER_CODES,
    broker_error,
    is_connection_error,
    is_retryable,
)
from .retry import RetryPolicy  # noqa: F401
from .records import (  # noqa: F401
    CorruptBatchError,
    decode_batch_meta,
    decode_message_set,
    decode_record_set,
    encode_control_batch,
    encode_message_set,
    encode_record_batch,
)
from .protocol import (  # noqa: F401
    API_ADD_PARTITIONS_TO_TXN,
    API_END_TXN,
    API_FETCH,
    API_INIT_PRODUCER_ID,
    API_PRODUCE,
    API_VERSIONS,
    IMPLEMENTED,
    ProtocolError,
    Reader,
    Writer,
    negotiate,
)
from .txn import (  # noqa: F401
    TransactionState,
    decode_add_partitions_response,
    decode_end_txn_response,
    decode_init_producer_id_response,
    encode_add_partitions_request,
    encode_end_txn_request,
    encode_init_producer_id_request,
)
from .varint import (  # noqa: F401
    decode_varint,
    decode_varlong,
    encode_varint,
    encode_varlong,
)

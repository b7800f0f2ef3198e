"""External-system connector layer.

``runtime/`` owns the engine-facing Source/Sink contracts (poll,
watermarks, checkpointable positions); this package owns the *wire
formats* those adapters speak. The first resident is the Kafka
protocol family (``connectors.kafka``): varints, CRC32C, v0/v1
message sets, v2 record batches, compression codecs, and API-version
negotiation. Future byte-stream connectors (files, sockets) share the
same codec registry rather than growing their own.
"""

"""Request/response wire primitives and API-version negotiation.

The Kafka protocol frames every request as ``size:int32`` then a
header ``api_key:int16 api_version:int16 correlation_id:int32
client_id:string`` and a big-endian body; responses echo the
correlation id. ``Writer``/``Reader`` are the shared builders for
both the client (runtime/kafka.py) and the in-process fake broker
(tests/fake_kafka.py).

Version negotiation (KIP-35): the client sends ApiVersions (api 18,
v0) once per connection and intersects each api's broker-supported
``[min, max]`` with the versions this codebase implements
(``IMPLEMENTED``), taking the highest. Pre-0.10 brokers don't know
the request and slam the connection — ``negotiate`` treats that as
"the v0 dialect everywhere", which is exactly what those brokers
speak. The negotiated picks decide, per broker, whether Fetch returns
v2 record batches (Fetch >= 4) and whether Produce may send them
(Produce >= 3) — the dialect boundary between the legacy message-set
world and the record-batch world.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from .errors import KafkaError

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_VERSIONS = 18
API_INIT_PRODUCER_ID = 22
API_ADD_PARTITIONS_TO_TXN = 24
API_END_TXN = 26

# api -> versions this codebase implements, best first. Produce v3 /
# Fetch v4 are the first versions whose record sets are v2 batches.
# The transactional trio (22/24/26, KIP-98) negotiates v0; a broker
# that predates them falls back to "v0" too (negotiate's blanket
# rule), so the transactional produce path must check the broker
# actually ADVERTISED them before relying on the dialect — see
# runtime/kafka.py's transactional preflight.
IMPLEMENTED: Dict[int, Tuple[int, ...]] = {
    API_PRODUCE: (3, 0),
    API_FETCH: (4, 0),
    API_LIST_OFFSETS: (0,),
    API_METADATA: (0,),
    API_VERSIONS: (0,),
    API_INIT_PRODUCER_ID: (0,),
    API_ADD_PARTITIONS_TO_TXN: (0,),
    API_END_TXN: (0,),
}


class Writer:
    def __init__(self) -> None:
        self.parts: List[bytes] = []

    def i8(self, v):
        self.parts.append(struct.pack(">b", v))
        return self

    def i16(self, v):
        self.parts.append(struct.pack(">h", v))
        return self

    def i32(self, v):
        self.parts.append(struct.pack(">i", v))
        return self

    def i64(self, v):
        self.parts.append(struct.pack(">q", v))
        return self

    def string(self, s: Optional[str]):
        if s is None:
            return self.i16(-1)
        b = s.encode("utf-8")
        self.i16(len(b))
        self.parts.append(b)
        return self

    def bytes_(self, b: Optional[bytes]):
        if b is None:
            return self.i32(-1)
        self.i32(len(b))
        self.parts.append(b)
        return self

    def raw(self, b: bytes):
        self.parts.append(b)
        return self

    def done(self) -> bytes:
        return b"".join(self.parts)


class ProtocolError(KafkaError):
    pass


class Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ProtocolError("short response")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self._take(n).decode("utf-8")

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else self._take(n)


def request_header(api: int, version: int, corr: int, client_id: str) -> bytes:
    return (
        Writer().i16(api).i16(version).i32(corr).string(client_id).done()
    )


def decode_api_versions_response(r: Reader) -> Dict[int, Tuple[int, int]]:
    """ApiVersions v0 response body -> {api_key: (min, max)}."""
    err = r.i16()
    if err:
        raise ProtocolError(f"ApiVersions: error {err}")
    out: Dict[int, Tuple[int, int]] = {}
    for _ in range(r.i32()):
        key, lo, hi = r.i16(), r.i16(), r.i16()
        out[key] = (lo, hi)
    return out


def encode_api_versions_response(
    versions: Dict[int, Tuple[int, int]]
) -> bytes:
    w = Writer().i16(0).i32(len(versions))
    for key in sorted(versions):
        lo, hi = versions[key]
        w.i16(key).i16(lo).i16(hi)
    return w.done()


def negotiate(
    broker_versions: Optional[Dict[int, Tuple[int, int]]],
) -> Dict[int, int]:
    """-> {api: version to speak}. ``None`` (broker predates
    ApiVersions) and apis the broker omits both fall back to v0 — the
    only dialect every broker understands."""
    picks: Dict[int, int] = {}
    for api, ours in IMPLEMENTED.items():
        pick = 0
        if broker_versions and api in broker_versions:
            lo, hi = broker_versions[api]
            for v in ours:
                if lo <= v <= hi:
                    pick = v
                    break
            else:
                raise ProtocolError(
                    f"api {api}: broker supports versions [{lo}, {hi}]"
                    f", client implements {list(ours)} — no overlap"
                )
        picks[api] = pick
    return picks

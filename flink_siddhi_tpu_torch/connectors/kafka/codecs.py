"""Compression-codec registry for record batches.

Codec ids are the low 3 bits of a v2 batch's (or a v0/v1 wrapper
message's) attributes field. gzip is implemented with the stdlib;
snappy, lz4 and zstd have real ids so a batch flagged with one is
*identified by name* in the rejection instead of failing as a
mystery bit pattern — the environment has none of those libraries and
silently skipping a compressed batch would drop every record in it.
"""

from __future__ import annotations

import gzip as _gzip
from typing import Dict

from .errors import KafkaError

CODEC_NONE = 0
CODEC_GZIP = 1
CODEC_SNAPPY = 2
CODEC_LZ4 = 3
CODEC_ZSTD = 4

_NAMES: Dict[int, str] = {
    CODEC_NONE: "none",
    CODEC_GZIP: "gzip",
    CODEC_SNAPPY: "snappy",
    CODEC_LZ4: "lz4",
    CODEC_ZSTD: "zstd",
}
_IDS: Dict[str, int] = {v: k for k, v in _NAMES.items()}


class UnsupportedCodecError(KafkaError):
    """A batch uses a codec this build cannot (de)compress."""


def codec_name(codec_id: int) -> str:
    return _NAMES.get(codec_id, f"unknown({codec_id})")


def codec_id(name: str) -> int:
    try:
        return _IDS[name.lower()]
    except KeyError:
        raise UnsupportedCodecError(
            f"unknown compression codec {name!r}; known: "
            f"{sorted(_IDS)}"
        ) from None


def _reject(cid: int, verb: str) -> UnsupportedCodecError:
    return UnsupportedCodecError(
        f"cannot {verb} codec {codec_name(cid)!r} (id {cid}): only "
        "'none' and 'gzip' are built in (stdlib); snappy/lz4/zstd "
        "need libraries this environment does not ship"
    )


def compress(codec: int, data: bytes) -> bytes:
    if codec == CODEC_NONE:
        return data
    if codec == CODEC_GZIP:
        # mtime=0: byte-identical output for identical input, so batch
        # CRCs are reproducible across encodes
        return _gzip.compress(data, compresslevel=6, mtime=0)
    raise _reject(codec, "compress with")


def decompress(codec: int, data: bytes) -> bytes:
    if codec == CODEC_NONE:
        return data
    if codec == CODEC_GZIP:
        return _gzip.decompress(data)
    raise _reject(codec, "decompress")

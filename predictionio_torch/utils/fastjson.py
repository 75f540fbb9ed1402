"""Cached JSON codecs for the serving path — own copy of the generic codec
pair of the reference's ``predictionio_tpu/utils/fastjson.py``.

`json.dumps(obj, separators=...)` builds a fresh JSONEncoder on every
call, and `json.loads(b"...")` detects the byte-order mark before it
reaches the C scanner. This module binds one compact C encoder and one C
decoder at import. The compact encoding is also the result cache's key of
a query (`serving/result_cache.py`), so it must stay the reference's,
byte for byte. The reference's envelope fragments and interned message
bodies are left out: the port's server encodes through `dumps_bytes`.
"""

from __future__ import annotations

import json

# One compact C encoder / one C decoder for the whole process, bound once.
_ENCODER = json.JSONEncoder(separators=(",", ":"))
_encode = _ENCODER.encode
_DECODER = json.JSONDecoder()
_decode = _DECODER.decode


def dumps_bytes(obj) -> bytes:
    """Compact-encode to UTF-8 bytes via the process-bound C encoder."""
    return _encode(obj).encode("utf-8")


def dumps(obj) -> str:
    return _encode(obj)


def loads(data):
    """Decode JSON from bytes or str, skipping json.loads' per-call
    BOM/encoding detection for the overwhelmingly common UTF-8 case.
    Raises json.JSONDecodeError / UnicodeDecodeError (a ValueError) on
    bad input — what the route handler maps to 400."""
    if isinstance(data, (bytes, bytearray)):
        data = data.decode("utf-8")
    return _decode(data)

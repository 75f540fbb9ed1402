"""Cached JSON codecs for the serving path — own copy of the generic codec
pair of the reference's ``predictionio_tpu/utils/fastjson.py``.

`json.dumps(obj, separators=...)` builds a fresh JSONEncoder on every
call, and `json.loads(b"...")` detects the byte-order mark before it
reaches the C scanner. This module binds one compact C encoder and one C
decoder at import. The compact encoding is also the result cache's key of
a query (`serving/result_cache.py`), so it must stay the reference's,
byte for byte. The event server's two fixed bodies come as the
reference's do: `event_id_response` assembles `{"eventId": ...}` from
preserialized fragments, and `message_body` interns the rendered
`{"message": ...}` bodies of a small vocabulary of replies. The
reference's encoder hit/miss counters and its prediction envelope are
left out.
"""

from __future__ import annotations

import json
import re

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


# JSON string characters that need no escaping: everything printable-ASCII
# except the two JSON-special characters. Event ids are uuid hex, so this
# matches essentially always; anything else takes the generic encoder.
_PLAIN_STR = re.compile(r'^[ !#-\[\]-~]*$')

_EVENT_ID_PRE = b'{"eventId":"'
_EVENT_ID_POST = b'"}'


def event_id_response(event_id: str) -> bytes:
    """`{"eventId": "..."}` — the 201 body of every single-event ingest."""
    if _PLAIN_STR.match(event_id):
        return _EVENT_ID_PRE + event_id.encode("ascii") + _EVENT_ID_POST
    return dumps_bytes({"eventId": event_id})


# {"message": ...} replies (shed, not found, invalid key) repeat a small
# vocabulary of strings: intern the rendered bytes, bounded so that a
# stream of distinct messages cannot grow the cache.
_MESSAGE_CACHE: dict = {}
_MESSAGE_CACHE_MAX = 512


def message_body(message: str) -> bytes:
    body = _MESSAGE_CACHE.get(message)
    if body is not None:
        return body
    body = dumps_bytes({"message": message})
    if len(_MESSAGE_CACHE) < _MESSAGE_CACHE_MAX:
        _MESSAGE_CACHE[message] = body
    return body

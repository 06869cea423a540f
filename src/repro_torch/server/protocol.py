"""Wire layer: minimal HTTP/1.1 + WebSocket over asyncio streams, and the
JSON codec between request bodies and the frozen :class:`SearchRequest`
(the port's copy of ``repro.server.protocol``).

Stdlib + numpy + torch only: the front end ships no web framework. The
implementation covers exactly what the serving plane needs:

* HTTP/1.1 request parsing with persistent connections (``Connection:
  keep-alive`` default), bounded header and body sizes, and typed 4xx
  errors (:class:`BadRequest` -> 400, :class:`PayloadTooLarge` -> 413)
  raised **at the boundary**, before any engine work.
* JSON responses with non-finite floats sanitized to ``null`` (a shed
  result's +inf scores must not emit invalid JSON).
* The RFC 6455 server handshake + frame codec (text/close/ping/pong, 16-
  and 64-bit extended lengths, client masking) for the stats stream.
* :func:`parse_search_request` — every wire field of the search body
  (queries/k/metric/tier/mode_hint/deadline_ms/filter_mask/allow_partial/
  max_retries/rid/tenant) validated with a named error message; unknown
  fields are rejected rather than silently dropped. Construction errors
  from ``SearchRequest.__post_init__`` surface as 400s too, so the wire
  contract and the API contract are the same contract.

One difference from the reference: the port's answers are torch tensors.
:func:`jsonable` turns CPU tensors of any rank into JSON numbers and lists
(non-finite floats to ``null``) and raises ``TypeError`` on a tensor that
is not on the CPU. The scheduler copies every answer to the host inside
its dispatch, on the dispatch worker; a device tensor reaching the codec
means a dispatch skipped that copy, and copying it here would make the
event loop wait on the card and stall every connection. So nothing on the
event loop calls ``.cpu()``, ``.item()`` or a synchronize on a card tensor.
:func:`encode_result` hands the result's tensors to :func:`jsonable` as
they are.
"""
from __future__ import annotations

import asyncio
import base64
import dataclasses
import hashlib
import json
import math
import os
import struct
from typing import Any, Mapping
from urllib.parse import parse_qsl, unquote, urlsplit

import numpy as np
import torch

from repro_torch.api.types import SearchRequest, SearchResult

__all__ = [
    "ProtocolError", "BadRequest", "PayloadTooLarge", "ConnectionClosed",
    "HttpRequest", "read_http_request", "http_response", "jsonable",
    "ws_accept_key", "ws_frame", "ws_read_frame",
    "OP_TEXT", "OP_BINARY", "OP_CLOSE", "OP_PING", "OP_PONG",
    "parse_search_request", "encode_result",
    "MAX_BODY_BYTES_DEFAULT",
]

#: default request-body ceiling (per request, enforced before the read)
MAX_BODY_BYTES_DEFAULT = 8 << 20

_REASONS = {
    101: "Switching Protocols",
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


class ConnectionClosed(Exception):
    """The peer closed the connection (clean EOF between requests)."""


class ProtocolError(Exception):
    """A wire-level error with an HTTP status; the server answers it and
    (when ``close`` is True) drops the connection, never crashes."""

    status = 400
    #: some errors leave unread bytes in the stream (an oversized body is
    #: never read), so the connection cannot be reused
    close = False

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class BadRequest(ProtocolError):
    status = 400


class PayloadTooLarge(ProtocolError):
    status = 413
    close = True


@dataclasses.dataclass
class HttpRequest:
    """One parsed HTTP/1.1 request."""

    method: str
    target: str                  # raw request target (path + query)
    path: str                    # decoded path only
    query: dict[str, str]
    headers: dict[str, str]      # keys lowercased
    body: bytes

    def json(self) -> Any:
        """Parse the body as JSON; malformed bodies are a 400, always."""
        if not self.body:
            raise BadRequest("empty body where a JSON object was expected")
        try:
            return json.loads(self.body)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise BadRequest(f"malformed JSON body: {e}") from None

    @property
    def keep_alive(self) -> bool:
        return self.headers.get("connection", "").lower() != "close"


async def read_http_request(
    reader: asyncio.StreamReader,
    max_body_bytes: int = MAX_BODY_BYTES_DEFAULT,
) -> HttpRequest:
    """Read one request off the stream; raises :class:`ConnectionClosed`
    on clean EOF, typed :class:`ProtocolError` on anything malformed."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            raise ConnectionClosed from None
        raise BadRequest("truncated request head") from None
    except asyncio.LimitOverrunError:
        err = BadRequest("request head exceeds the stream limit")
        err.close = True
        raise err from None
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise BadRequest(f"malformed request line: {lines[0]!r}")
    method, target = parts[0].upper(), parts[1]
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise BadRequest(f"malformed header line: {line!r}")
        headers[name.strip().lower()] = value.strip()
    split = urlsplit(target)
    query = dict(parse_qsl(split.query, keep_blank_values=True))
    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise BadRequest(
                f"malformed Content-Length: {headers['content-length']!r}"
            ) from None
        if n < 0:
            raise BadRequest(f"negative Content-Length: {n}")
        if n > max_body_bytes:
            # refuse BEFORE reading: the bytes stay unread in the stream,
            # so the error closes the connection after answering 413
            raise PayloadTooLarge(
                f"body of {n} bytes exceeds the {max_body_bytes}-byte limit"
            )
        try:
            body = await reader.readexactly(n)
        except asyncio.IncompleteReadError:
            raise ConnectionClosed from None
    elif headers.get("transfer-encoding"):
        err = BadRequest("chunked request bodies are not supported")
        err.close = True
        raise err
    return HttpRequest(method=method, target=target,
                       path=unquote(split.path), query=query,
                       headers=headers, body=body)


def jsonable(obj: Any) -> Any:
    """Recursively convert stats payloads to strict JSON: numpy scalars and
    CPU tensors to Python numbers and lists, sets/tuples to sorted
    lists/lists, non-finite floats to None (strict JSON has no
    Infinity/NaN). A tensor that is not on the CPU raises ``TypeError``:
    the codec runs on the event loop, which must never wait on the card."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            raise TypeError(
                f"cannot encode a tensor on {obj.device}: answers must reach "
                "the host inside the dispatch, never on the event loop")
        return jsonable(obj.tolist())
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(jsonable(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return [jsonable(v) for v in obj.tolist()]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        f = float(obj)
        return f if math.isfinite(f) else None
    return obj


def http_response(
    status: int,
    payload: Any = None,
    headers: Mapping[str, str] | None = None,
    close: bool = False,
) -> bytes:
    """One full HTTP/1.1 response; dict payloads are JSON-encoded."""
    if payload is None:
        body = b""
        ctype = None
    elif isinstance(payload, (bytes, bytearray)):
        body = bytes(payload)
        ctype = "application/octet-stream"
    else:
        body = json.dumps(jsonable(payload), allow_nan=False).encode()
        ctype = "application/json"
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
    if ctype is not None:
        lines.append(f"Content-Type: {ctype}")
    lines.append(f"Content-Length: {len(body)}")
    lines.append(f"Connection: {'close' if close else 'keep-alive'}")
    for name, value in (headers or {}).items():
        lines.append(f"{name}: {value}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


# ------------------------------------------------------------------ websocket
_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x1, 0x2, 0x8, 0x9, 0xA


def ws_accept_key(client_key: str) -> str:
    """RFC 6455 handshake digest for ``Sec-WebSocket-Accept``."""
    digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def ws_frame(payload: bytes | str, opcode: int = OP_TEXT,
             mask: bool = False) -> bytes:
    """Encode one final frame. Servers send unmasked; a client (the load
    generator, tests) passes ``mask=True`` as RFC 6455 requires."""
    data = payload.encode() if isinstance(payload, str) else bytes(payload)
    head = bytearray([0x80 | (opcode & 0x0F)])
    mask_bit = 0x80 if mask else 0
    n = len(data)
    if n < 126:
        head.append(mask_bit | n)
    elif n < 1 << 16:
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        data = bytes(b ^ key[i % 4] for i, b in enumerate(data))
    return bytes(head) + data


async def ws_read_frame(reader: asyncio.StreamReader) -> tuple[int, bytes]:
    """Read one frame; returns (opcode, unmasked payload)."""
    try:
        b0, b1 = await reader.readexactly(2)
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack(">H", await reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack(">Q", await reader.readexactly(8))
        key = await reader.readexactly(4) if b1 & 0x80 else None
        data = await reader.readexactly(n) if n else b""
    except (asyncio.IncompleteReadError, ConnectionResetError):
        raise ConnectionClosed from None
    if key is not None:
        data = bytes(b ^ key[i % 4] for i, b in enumerate(data))
    return b0 & 0x0F, data


# ------------------------------------------------------------- search codec
#: every field the search body accepts; anything else is a named 400
_SEARCH_FIELDS = frozenset({
    "queries", "k", "metric", "tier", "mode_hint", "deadline_ms",
    "filter_mask", "allow_partial", "max_retries", "rid", "tenant",
})
_METRICS = ("l2", "ip", "cos")


def _as_int(payload: Mapping, field: str) -> int | None:
    v = payload.get(field)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise BadRequest(f"'{field}' must be an integer, got {v!r}")
    return v


def _as_bool(payload: Mapping, field: str) -> bool:
    v = payload.get(field, False)
    if not isinstance(v, bool):
        raise BadRequest(f"'{field}' must be a boolean, got {v!r}")
    return v


def parse_search_request(
    payload: Any,
    arrival_s: float = 0.0,
    n_ids: int | None = None,
) -> tuple[SearchRequest, str]:
    """Body dict -> (frozen :class:`SearchRequest`, tenant id).

    Every violation raises :class:`BadRequest` naming the offending field —
    the 4xx happens at the boundary, never inside the dispatch path.
    ``n_ids`` (the collection's global id-space size) validates the
    ``filter_mask`` length up front when known.
    """
    if not isinstance(payload, Mapping):
        raise BadRequest(
            f"request body must be a JSON object, got {type(payload).__name__}"
        )
    unknown = sorted(set(payload) - _SEARCH_FIELDS)
    if unknown:
        raise BadRequest(
            f"unknown field(s) {unknown}; accepted: {sorted(_SEARCH_FIELDS)}"
        )
    if "queries" not in payload:
        raise BadRequest("missing required field 'queries'")
    try:
        q = np.asarray(payload["queries"], dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise BadRequest(f"'queries' is not a numeric array: {e}") from None
    if q.ndim not in (1, 2) or q.size == 0:
        raise BadRequest(
            f"'queries' must be a (d,) vector or (m, d) matrix, got shape "
            f"{q.shape}"
        )
    if not np.all(np.isfinite(q)):
        raise BadRequest("'queries' contains non-finite values")

    tenant = payload.get("tenant", "default")
    if not isinstance(tenant, str) or not tenant:
        raise BadRequest(f"'tenant' must be a non-empty string, got {tenant!r}")

    metric = payload.get("metric")
    if metric is not None and metric not in _METRICS:
        raise BadRequest(f"'metric' must be one of {_METRICS}, got {metric!r}")

    deadline_ms = payload.get("deadline_ms")
    if deadline_ms is not None:
        if isinstance(deadline_ms, bool) or not isinstance(
                deadline_ms, (int, float)):
            raise BadRequest(f"'deadline_ms' must be a number, got "
                             f"{deadline_ms!r}")
        deadline_ms = float(deadline_ms)
        if not math.isfinite(deadline_ms) or deadline_ms <= 0:
            raise BadRequest(f"'deadline_ms' must be a positive finite "
                             f"number, got {deadline_ms}")

    mask = payload.get("filter_mask")
    if mask is not None:
        try:
            mask = np.asarray(mask)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"'filter_mask' is not an array: {e}") from None
        if mask.ndim != 1 or mask.dtype.kind not in "biu":
            raise BadRequest(
                "'filter_mask' must be a flat list of booleans/0-1 over the "
                f"collection's id space, got dtype {mask.dtype} shape "
                f"{mask.shape}"
            )
        mask = mask.astype(bool)
        if n_ids is not None and mask.shape[0] != n_ids:
            raise BadRequest(
                f"'filter_mask' has {mask.shape[0]} entries but the "
                f"collection's id space holds {n_ids}"
            )

    tier = payload.get("tier", "auto")
    mode_hint = payload.get("mode_hint", "auto")
    try:
        req = SearchRequest(
            queries=q,
            k=_as_int(payload, "k"),
            metric=metric,
            tier=tier,
            mode_hint=mode_hint,
            deadline_ms=deadline_ms,
            filter_mask=mask,
            allow_partial=_as_bool(payload, "allow_partial"),
            max_retries=_as_int(payload, "max_retries"),
            rid=_as_int(payload, "rid"),
            arrival_s=arrival_s,
        )
    except (TypeError, ValueError) as e:
        # SearchRequest.__post_init__ validation (k >= 1, tier/mode_hint
        # vocabularies, max_retries >= 0, ...) IS the wire contract
        raise BadRequest(str(e)) from None
    if req.tier == "int8" and req.mode_hint == "fdsq":
        raise BadRequest(
            "tier='int8' is a throughput (FQ-SD) tier and cannot serve "
            "mode_hint='fdsq'"
        )
    return req, tenant


def encode_result(result: SearchResult) -> dict:
    """One served :class:`SearchResult` -> response body dict.

    Shed results (`stats["mode"] == "shed"`) keep their documented envelope
    — empty top-k, ``shed: true`` — rather than pretending to be answers.
    """
    stats = dict(result.stats)
    shed = bool(stats.get("shed", False))
    body = {
        "rid": result.rid,
        "mode": stats.get("mode"),
        "tier": result.tier,
        "shed": shed,
        "partial": bool(stats.get("partial", False)),
        "stats": {
            "latency_ms": stats.get("latency_ms"),
            "batched": stats.get("batched"),
            "deadline_ms": stats.get("deadline_ms"),
            "health": stats.get("health", {}),
        },
    }
    if shed:
        body["scores"] = []
        body["indices"] = []
        body["certified"] = False
    else:
        body["scores"] = result.scores
        body["indices"] = result.indices
        body["certified"] = result.certified
    return jsonable(body)

"""One request-body reader for the port's standard-library HTTP servers
(the event server, the query server, the fleet gateway, the admin server
and the dashboard).

``http.server`` leaves the body to the handler, and reading it only by
``Content-Length`` breaks a keep-alive connection twice over: a chunked
body is taken for the next request line, and a negative or non-numeric
length either blocks in ``rfile.read(-1)`` or kills the handler without an
answer. The JAX package's aiohttp servers decode ``Transfer-Encoding:
chunked`` and answer 400 to a malformed length; :func:`read_body` does the
same here. A chunked body is held to the caller's size limit as it
arrives, so it cannot get round the 413 a ``Content-Length`` gets.
"""

from __future__ import annotations

from typing import BinaryIO, Mapping

# longest chunk-size or trailer line read before giving up on the request
MAX_LINE = 65_536


class BodyError(Exception):
    """The request's framing is malformed: answer ``status`` and close the
    connection, since the end of the body is unknown."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class BodyTooLarge(BodyError):
    """The body is past the limit: ``length`` is the announced
    ``Content-Length``, or for a chunked body the bytes seen so far. The
    rest of the body stays unread."""

    def __init__(self, length: int, limit: int):
        super().__init__(413, f"payload too large ({length} > {limit} bytes)")
        self.length = length
        self.limit = limit


def _line(rfile: BinaryIO, what: str) -> bytes:
    raw = rfile.readline(MAX_LINE + 1)
    if len(raw) > MAX_LINE:
        raise BodyError(400, f"{what} line too long")
    if not raw.endswith(b"\n"):
        raise BodyError(400, f"truncated chunked body ({what})")
    return raw.rstrip(b"\r\n")


def _read_exactly(rfile: BinaryIO, n: int) -> bytes:
    data = rfile.read(n)
    if len(data) != n:
        raise BodyError(400, f"truncated body ({len(data)} of {n} bytes)")
    return data


def _read_chunked(rfile: BinaryIO, limit: int | None) -> bytes:
    parts, total = [], 0
    while True:
        size_field = _line(rfile, "chunk size").split(b";", 1)[0].strip()
        if not size_field or any(c not in b"0123456789abcdefABCDEF" for c in size_field):
            raise BodyError(400, f"invalid chunk size {size_field[:32]!r}")
        size = int(size_field, 16)
        if size == 0:
            break
        total += size
        if limit is not None and total > limit:
            raise BodyTooLarge(total, limit)
        parts.append(_read_exactly(rfile, size))
        if rfile.read(2) != b"\r\n":
            raise BodyError(400, "chunk data not followed by CRLF")
    while _line(rfile, "trailer"):  # trailer fields, up to the empty line
        pass
    return b"".join(parts)


def framing(headers: Mapping[str, str]) -> int | None:
    """How the body is framed, checked before anything is read: None for
    a chunked body (``Transfer-Encoding: chunked``), else its
    ``Content-Length`` (0 without the header). Raises :class:`BodyError`
    (400) on a negative or non-numeric length, a length beside a transfer
    coding, or an unknown coding."""
    coding = headers.get("Transfer-Encoding")
    raw_length = headers.get("Content-Length")
    if coding is not None:
        if coding.strip().lower() != "chunked":
            raise BodyError(400, f"unsupported Transfer-Encoding {coding!r}")
        if raw_length is not None:
            raise BodyError(400, "Content-Length beside Transfer-Encoding")
        return None
    if raw_length is None:
        return 0
    text = raw_length.strip()
    if not text.isascii() or not text.isdigit():
        raise BodyError(400, f"invalid Content-Length {raw_length[:32]!r}")
    return int(text)


def read_body(headers: Mapping[str, str], rfile: BinaryIO, limit: int | None = None) -> bytes:
    """The request body as :func:`framing` says it is framed. ``limit``
    (None or 0: none) bounds either kind. Raises :class:`BodyTooLarge`
    past the limit, and :class:`BodyError` on bad framing, a bad chunk
    size or a body cut short."""
    limit = limit or None
    length = framing(headers)
    if length is None:
        return _read_chunked(rfile, limit)
    if limit is not None and length > limit:
        raise BodyTooLarge(length, limit)
    return _read_exactly(rfile, length) if length else b""


def reply_bad_framing(handler, exc: BodyError) -> None:
    """Answer a :class:`BodyError` in plain text, as aiohttp answers a
    malformed request, and close the connection."""
    data = f"{exc.message}\n".encode()
    handler.close_connection = True
    handler.send_response(exc.status)
    handler.send_header("Content-Type", "text/plain; charset=utf-8")
    handler.send_header("Content-Length", str(len(data)))
    handler.send_header("Connection", "close")
    handler.end_headers()
    handler.wfile.write(data)

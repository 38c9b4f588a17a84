"""Server-side TLS shared by the event server and the query server (port
of ``predictionio_tpu/utils/tls.py``, ref ``SSLConfiguration.scala:33``).

Both servers run on the standard library's ``ThreadingHTTPServer``, whose
one serve thread calls ``accept()``. A listening socket wrapped for TLS
would run each handshake inside that ``accept()``, so one client that
connects and sends nothing would stall every other client.
:class:`HandshakeOnHandlerThread` wraps each accepted connection without
handshaking and runs the handshake, bounded by ``handshake_timeout_s``, on
the connection's own handler thread.
"""

from __future__ import annotations

import logging
import socket
import ssl

logger = logging.getLogger(__name__)


def server_ssl_context(certfile: str | None, keyfile: str | None) -> ssl.SSLContext | None:
    """SSLContext from a PEM cert/key pair; None when TLS is off. Exactly
    one of the pair set is an error, never a silent plaintext server."""
    if bool(certfile) != bool(keyfile):
        raise ValueError("TLS misconfigured: both ssl_certfile and ssl_keyfile are required")
    if not certfile:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


class HandshakeOnHandlerThread:
    """Mixin for a ``socketserver.ThreadingMixIn`` server: with
    ``ssl_context`` set, accepted connections are TLS, handshaken on their
    handler thread. A connection whose handshake fails or times out is
    closed without a response."""

    ssl_context: ssl.SSLContext | None = None
    handshake_timeout_s: float = 10.0

    def get_request(self) -> tuple[socket.socket, object]:
        sock, addr = super().get_request()
        if self.ssl_context is not None:
            sock = self.ssl_context.wrap_socket(sock, server_side=True, do_handshake_on_connect=False)
        return sock, addr

    def finish_request(self, request, client_address) -> None:
        if isinstance(request, ssl.SSLSocket):
            request.settimeout(self.handshake_timeout_s)
            try:
                request.do_handshake()
            except (OSError, ValueError) as exc:  # ssl.SSLError and timeouts are OSErrors
                logger.debug("TLS handshake with %s failed: %s", client_address, exc)
                return
            request.settimeout(None)
        super().finish_request(request, client_address)

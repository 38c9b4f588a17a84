"""A route table behind the standard library's ``ThreadingHTTPServer``:
the base of ``pio adminserver`` and ``pio dashboard``, whose JAX
counterparts are aiohttp applications."""

from __future__ import annotations

import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from predictionio_tpu_torch.utils.httpbody import BodyError, read_body, reply_bad_framing


class RouteServer:
    """Subclasses answer :meth:`route`; this class binds, serves every
    request on a thread of its own, and stops."""

    thread_name = "pio-route-server"

    def __init__(self):
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def route(self, method: str, path: str, body: bytes) -> tuple[int, str, bytes]:
        """(status, content type, body) of one request."""
        raise NotImplementedError

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _serve(self) -> None:
                try:
                    body = read_body(self.headers, self.rfile)
                except BodyError as exc:
                    reply_bad_framing(self, exc)
                    return
                status, ctype, data = server.route(self.command, urllib.parse.urlsplit(self.path).path, body)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_DELETE = do_PUT = _serve

        return Handler

    def start(self, ip: str, port: int) -> int:
        """Bind and serve on a background thread; returns the bound port."""
        httpd = ThreadingHTTPServer((ip, port), self._handler())
        httpd.daemon_threads = True
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever, name=self.thread_name, daemon=True)
        self._thread.start()
        return httpd.server_address[1]

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None

"""The HTTP base of the JAX package's ``ui/server.py``:
:class:`JsonHTTPHandler` and :class:`BackgroundHTTPServer`, which the
telemetry endpoint (``observability/telemetry.py``) serves on. The
training UI itself (``UIServer`` and its pages) is ROADMAP queue A11."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class JsonHTTPHandler(BaseHTTPRequestHandler):
    """HTTP plumbing for the port's servers (``observability/telemetry.py``):
    quiet request logging plus typed response senders. Subclasses
    implement ``do_GET`` / ``do_POST``."""

    def log_message(self, *args):
        pass

    def _send(self, body: bytes, ctype: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, payload, code: int = 200) -> None:
        self._send(json.dumps(payload).encode(), "application/json", code)

    def _html(self, page: str) -> None:
        self._send(page.encode(), "text/html")

    def _js(self, script: str) -> None:
        self._send(script.encode(), "application/javascript")

    def _text(self, body: str, ctype: str = "text/plain") -> None:
        self._send(body.encode(), ctype)


class BackgroundHTTPServer:
    """A ThreadingHTTPServer on a daemon thread with start() / stop(): bind,
    resolve the ephemeral port, serve in the background, shut down
    cleanly."""

    def __init__(self, handler_cls, host: str = "0.0.0.0", port: int = 0):
        self.handler_cls = handler_cls
        self.host = host
        self.port = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "BackgroundHTTPServer":
        if self._server is None:
            self._server = ThreadingHTTPServer((self.host, self.port),
                                               self.handler_cls)
            self.port = self._server.server_address[1]
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host == "0.0.0.0" else self.host
        return f"http://{host}:{self.port}"

"""Dependency-free HTTP server for the /t2v API of the port.

FastAPI is not available in every serving image; this stdlib
ThreadingHTTPServer implements the same endpoint surface as
``t2v_torch.api.app.create_app`` (which mirrors the reference's
api_t2v.py):

  GET  /t2v/api_version   GET  /t2v/version   GET  /t2v/progress
  POST /t2v/interrupt     POST /t2v/skip      POST /t2v/metadata
  POST /t2v/run?prompt=...&steps=...   (query params; multipart file
       uploads for vid2vid_input / inpainting_image)

Like the FastAPI app, this is a thin *transport*: request semantics,
status codes and payload shapes come from ``t2v_torch.api.handlers``,
shared by both servers so they cannot drift. The port's copy of the JAX
package's ``api/stdlib_server.py``.
"""

from __future__ import annotations

import json
import threading
from email.parser import BytesParser
from email.policy import default as email_policy
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from t2v_torch.api import handlers


class T2VRequestHandler(BaseHTTPRequestHandler):
    pipe = None  # class attributes set by serve()
    device = "cuda"

    def _json(self, content: dict, status: int = 200):
        body = json.dumps(content).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send(self, resp: handlers.ApiResponse):
        self._json(resp.payload, resp.status)

    def log_message(self, fmt, *args):  # quieter default logging
        pass

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/":
            from t2v_torch.api.webui import INDEX_HTML

            body = INDEX_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path == "/t2v/api_version":
            return self._json(handlers.api_version_payload())
        if path == "/t2v/version":
            return self._json(handlers.version_payload())
        if path == "/t2v/progress":
            return self._json(handlers.progress_payload())
        self._json({"detail": "Not Found"}, 404)

    def do_POST(self):
        parsed = urlparse(self.path)
        if parsed.path == "/t2v/interrupt":
            return self._send(handlers.interrupt_response())
        if parsed.path == "/t2v/skip":
            return self._send(handlers.skip_response())
        if parsed.path == "/t2v/metadata":
            uploads = self._read_uploads()
            if uploads is None:  # over the size cap
                return self._json({"detail": "uploaded file too large"}, 413)
            blob = next(iter(uploads.values()), None)
            return self._send(handlers.metadata_response(blob))
        if parsed.path != "/t2v/run":
            return self._json({"detail": "Not Found"}, 404)

        query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
        uploads = self._read_uploads()
        if uploads is None:
            return self._json({"detail": "uploaded file too large"}, 413)
        self._send(handlers.run_response(query, uploads, pipe=self.pipe, device=self.device))

    def _read_uploads(self):
        """Multipart body → {field: bytes}; None when over the upload cap."""
        length = int(self.headers.get("Content-Length") or 0)
        if length > handlers.MAX_UPLOAD_BYTES:
            # drain is pointless at this size — signal and let the client go
            return None
        ctype = self.headers.get("Content-Type", "")
        if length == 0 or "multipart/form-data" not in ctype:
            if length:
                self.rfile.read(length)
            return {}
        raw = self.rfile.read(length)
        msg = BytesParser(policy=email_policy).parsebytes(
            b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + raw
        )
        out = {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name:
                out[name] = part.get_payload(decode=True)
        return out


def serve(host: str = "127.0.0.1", port: int = 7860, pipe=None, *, block: bool = True,
          device: str = "cuda"):
    """Start the API server. Returns the server object (non-blocking mode
    runs it on a daemon thread — used by tests). Requests run on ``pipe``,
    or on the model they name, loaded on ``device``."""
    handler = type("Handler", (T2VRequestHandler,), {"pipe": pipe, "device": device})
    server = ThreadingHTTPServer((host, port), handler)
    if block:
        print(f"t2v API listening on http://{host}:{port}")
        server.serve_forever()
    else:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
    return server

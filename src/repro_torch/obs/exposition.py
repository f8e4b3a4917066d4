"""Exposition surface: a stdlib HTTP thread serving /metrics + /health
(counterpart of ``repro.obs.exposition``, the same code).

:class:`MetricsServer` runs a ``ThreadingHTTPServer`` on a daemon thread:

    ``GET /metrics``  Prometheus text format (0.0.4) rendered from the
                      registry (explicit, or whatever is installed at
                      request time);
    ``GET /health``   JSON from a caller-supplied callback — the serving
                      session wires ``health_stats()`` here;
    ``GET /trace``    current trace collector's Chrome trace JSON, 404
                      when no ``trace()`` is active.

Bound to localhost by default — an operator surface, not a public API.
Also hosts :func:`parse_prometheus`, the text-format parser ``gp_top``
uses to read either a live endpoint or a scraped file.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from . import registry as _registry
from .trace import active_trace as _active_trace


class MetricsServer:
    """Serve /metrics, /health, /trace from a daemon thread."""

    def __init__(
        self,
        port: int = 0,
        *,
        host: str = "127.0.0.1",
        registry=None,
        health_fn: Optional[Callable[[], dict]] = None,
    ):
        self._host = host
        self._port_requested = port
        self._registry = registry
        self._health_fn = health_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    # late-bound so a registry installed after start() is still served
    def _resolve_registry(self):
        return self._registry if self._registry is not None else _registry.active()

    def start(self) -> "MetricsServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr noise
                pass

            def _send(self, code: int, content_type: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        reg = server._resolve_registry()
                        text = reg.render_prometheus() if reg is not None else ""
                        self._send(
                            200,
                            "text/plain; version=0.0.4; charset=utf-8",
                            text.encode(),
                        )
                    elif path == "/health":
                        payload = (
                            server._health_fn()
                            if server._health_fn is not None
                            else {"status": "no health source wired"}
                        )
                        self._send(
                            200,
                            "application/json",
                            json.dumps(payload, default=str).encode(),
                        )
                    elif path == "/trace":
                        col = _active_trace()
                        if col is None:
                            self._send(404, "text/plain", b"no active trace\n")
                        else:
                            self._send(
                                200, "application/json", col.to_json().encode()
                            )
                    else:
                        self._send(404, "text/plain", b"not found\n")
                except BrokenPipeError:  # client went away mid-write
                    pass

        self._httpd = ThreadingHTTPServer((self._host, self._port_requested), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"metrics-server:{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text format into {name: {"type", "samples"}}.

    ``samples`` is a list of ``(labels_dict, value)``; histogram component
    series (``*_bucket``/``*_sum``/``*_count``) are folded back under the
    family name with the suffix recorded in the label dict as ``__part``.
    Only what gp_top needs — not a general scrape client.
    """
    families: dict = {}
    types: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        try:
            name_labels, value_s = line.rsplit(" ", 1)
            value = float(value_s)
        except ValueError:
            continue
        if "{" in name_labels:
            name, rest = name_labels.split("{", 1)
            labels = _parse_labels(rest.rstrip("}"))
        else:
            name, labels = name_labels, {}
        family, part = name, "value"
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base is not None and types.get(base) == "histogram":
                family, part = base, suffix.lstrip("_")
                break
        labels["__part"] = part
        families.setdefault(
            family, {"type": types.get(family, "untyped"), "samples": []}
        )["samples"].append((labels, value))
    return families


def _parse_labels(body: str) -> dict:
    labels: dict = {}
    i, n = 0, len(body)
    while i < n:
        eq = body.index("=", i)
        key = body[i:eq]
        assert body[eq + 1] == '"'
        j = eq + 2
        val = []
        while body[j] != '"':
            if body[j] == "\\":
                j += 1
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(body[j], body[j]))
            else:
                val.append(body[j])
            j += 1
        labels[key] = "".join(val)
        i = j + 1
        if i < n and body[i] == ",":
            i += 1
    return labels

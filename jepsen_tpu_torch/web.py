"""L7 UI: a web browser for the store.

Counterpart of jepsen.web (jepsen/src/jepsen/web.clj): a table of runs
(web.clj:122), per-run directory listings (207), zip export of a run
(258-299), and a path-traversal guard (300) — built on http.server, no
dependencies.

The port's copy of `jepsen_tpu/web.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import html
import io
import json
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import quote, unquote

from .store import Store

CONTENT_TYPES = {
    ".txt": "text/plain", ".edn": "text/plain", ".log": "text/plain",
    ".json": "application/json", ".jsonl": "application/json",
    ".html": "text/html", ".svg": "image/svg+xml", ".png": "image/png",
    ".pcap": "application/vnd.tcpdump.pcap",
}


def _page(title: str, body: str) -> bytes:
    return (f"<!doctype html><html><head><title>{html.escape(title)}</title>"
            "<style>body{font-family:monospace;margin:2em} "
            "table{border-collapse:collapse} td,th{padding:.3em .8em;"
            "border-bottom:1px solid #ddd;text-align:left}</style>"
            f"</head><body><h1>{html.escape(title)}</h1>{body}"
            "</body></html>").encode()


def _valid_str(results: dict | None) -> str:
    if results is None:
        return "?"
    v = results.get("valid?")
    return {True: "valid", False: "INVALID"}.get(v, "unknown")


class StoreHandler(BaseHTTPRequestHandler):
    store: Store = None  # set by serve()

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "text/html") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _safe_path(self, rel: str) -> Path | None:
        """Resolve rel under the store root; None if it escapes
        (web.clj:300 traversal guard)."""
        base = self.store.base.resolve()
        p = (base / rel).resolve()
        return p if p == base or base in p.parents else None

    def do_GET(self):
        path = unquote(self.path.split("?")[0]).lstrip("/")
        if path == "":
            return self._home()
        if path.startswith("zip/"):
            return self._zip(path[4:])
        if path.startswith("files/"):
            return self._files(path[6:])
        self._send(404, _page("404", "<p>not found</p>"))

    def _home(self):
        rows = []
        for name, runs in sorted(self.store.tests().items()):
            for start, d in sorted(runs.items(), reverse=True):
                results = self.store.load_results(d)
                rel = f"{name}/{start}"
                rows.append(
                    f"<tr><td><a href='/files/{quote(rel)}'>"
                    f"{html.escape(name)}</a></td>"
                    f"<td>{html.escape(start)}</td>"
                    f"<td>{_valid_str(results)}</td>"
                    f"<td><a href='/zip/{quote(rel)}'>zip</a></td></tr>")
        body = ("<table><tr><th>test</th><th>time</th><th>valid?</th>"
                "<th></th></tr>" + "".join(rows) + "</table>")
        self._send(200, _page("jepsen-tpu store", body))

    def _files(self, rel: str):
        p = self._safe_path(rel)
        if p is None or not p.exists():
            return self._send(404, _page("404", "<p>not found</p>"))
        if p.is_dir():
            entries = sorted(p.iterdir())
            items = "".join(
                f"<li><a href='/files/{quote(rel)}/{quote(e.name)}'>"
                f"{html.escape(e.name)}{'/' if e.is_dir() else ''}</a></li>"
                for e in entries)
            return self._send(200, _page(rel, f"<ul>{items}</ul>"))
        ctype = CONTENT_TYPES.get(p.suffix, "application/octet-stream")
        self._send(200, p.read_bytes(), ctype)

    def _zip(self, rel: str):
        p = self._safe_path(rel)
        if p is None or not p.is_dir():
            return self._send(404, _page("404", "<p>not found</p>"))
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for f in sorted(p.rglob("*")):
                if f.is_file():
                    z.write(f, f.relative_to(p.parent))
        self._send(200, buf.getvalue(), "application/zip")


def make_server(store: Store, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    handler = type("BoundStoreHandler", (StoreHandler,), {"store": store})
    return ThreadingHTTPServer((host, port), handler)


def serve(store: Store, host: str = "0.0.0.0", port: int = 8080) -> None:
    srv = make_server(store, host, port)
    print(f"serving {store.base} on http://{host}:{port}")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()

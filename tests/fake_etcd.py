"""In-process fake etcd: the v2 keys API over localhost HTTP, enough for
the etcd suite's CAS-register client (GET a key, PUT a value, PUT with
`prevValue`/`prevExist`). A missing key answers 404, a failed compare
412, as etcd does. The handler is the one of tests/test_suites.py's
`FakeEtcd`, with the store held by its server, as the other fakes
hold theirs.

    with FakeEtcdServer() as srv:
        ...  # http://127.0.0.1:{srv.port}/v2/keys/r<k>

`delay` (seconds) stalls every reply: a client whose timeout is shorter
sees a timeout.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class _EtcdHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _reply(self, code, obj):
        owner = self.server.owner  # type: ignore[attr-defined]
        if owner.delay:
            time.sleep(owner.delay)
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        owner = self.server.owner  # type: ignore[attr-defined]
        key = urlparse(self.path).path.rsplit("/", 1)[-1]
        with owner.lock:
            if key not in owner.store:
                return self._reply(404, {"errorCode": 100})
            value = owner.store[key]
        return self._reply(200, {"node": {"value": str(value)}})

    def do_PUT(self):
        owner = self.server.owner  # type: ignore[attr-defined]
        u = urlparse(self.path)
        key = u.path.rsplit("/", 1)[-1]
        q = parse_qs(u.query)
        n = int(self.headers.get("Content-Length", 0))
        form = parse_qs(self.rfile.read(n).decode())
        value = form.get("value", [None])[0]
        with owner.lock:
            if "prevValue" in q:
                cur = owner.store.get(key)
                if cur is None:
                    return self._reply(404, {"errorCode": 100})
                if str(cur) != q["prevValue"][0]:
                    return self._reply(412, {"errorCode": 101})
            owner.store[key] = value
        return self._reply(200, {"node": {"value": value}})


class _Server(ThreadingHTTPServer):
    daemon_threads = True


class FakeEtcdServer:
    def __init__(self, delay: float = 0.0):
        self.store: dict = {}
        self.lock = threading.Lock()
        self.delay = delay
        self._srv = _Server(("127.0.0.1", 0), _EtcdHandler)
        self._srv.owner = self
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True)
        self._thread.start()

    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

"""RobustIRC suite.

Counterpart of robustirc/src/jepsen/robustirc.clj (217 LoC + the
gencert.go TLS helper): a raft-replicated IRC network whose messages
must never be lost or reordered. The client speaks the robustsession
HTTP+JSON protocol directly (create session / post message / stream
messages) — each set-add is a PRIVMSG to the test channel, the final
read drains the channel backlog. TLS cert generation is handled by
openssl on-node instead of the reference's Go helper.

The port's copy of `jepsen_tpu/suites/robustirc.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import json
import socket
import ssl
import uuid
import urllib.error
import urllib.request

from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import nemesis as jnemesis, os_setup
from ..control import util as cutil
from ..workloads import queue as queue_wl
from . import base_opts, standard_workloads, suite_test
from .sql import resolve

DIR = "/opt/robustirc"
PIDFILE = f"{DIR}/robustirc.pid"
LOGFILE = f"{DIR}/robustirc.log"


class RobustIRCDB(jdb.DB, jdb.LogFiles):
    """go install + self-signed cert + join node 0
    (db, robustirc.clj:40-110)."""

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("apt-get", "install", "-y", "golang", "openssl")
        sess.exec("sh", "-c",
                  f"test -x {DIR}/robustirc || "
                  f"GOPATH={DIR}/go go install "
                  f"github.com/robustirc/robustirc@latest")
        sess.exec("mkdir", "-p", DIR)
        # self-signed cert (replaces resources/gencert.go)
        sess.exec("sh", "-c",
                  f"test -f {DIR}/cert.pem || openssl req -x509 "
                  f"-newkey rsa:2048 -keyout {DIR}/key.pem "
                  f"-out {DIR}/cert.pem -days 1 -nodes "
                  f"-subj /CN={node}")
        nodes = test.get("nodes", [node])
        args = [f"{DIR}/go/bin/robustirc",
                "-network_name", "jepsen",
                "-peer_addr", f"{node}:13001",
                "-tls_cert_path", f"{DIR}/cert.pem",
                "-tls_key_path", f"{DIR}/key.pem"]
        if node != nodes[0]:
            args += ["-join", f"{nodes[0]}:13001"]
        else:
            args += ["-singlenode"]
        cutil.start_daemon(sess, *args, logfile=LOGFILE,
                           pidfile=PIDFILE, chdir=DIR)

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", f"{DIR}/data")

    def log_files(self, test, node):
        return [LOGFILE]


CHANNEL = "#jepsen"


class RobustIRCClient(jclient.Client):
    """Set ops over the robustsession protocol
    (github.com/robustirc/robustirc: POST /robustirc/v1/session,
    POST .../message, GET .../messages), mirroring the reference's
    SetClient (robustirc.clj:150-180): add = `TOPIC #jepsen :v` (topic
    changes are broadcast to every member *including the setter*, so a
    reader sees its own adds — unlike PRIVMSG), read = drain the
    message stream and collect TOPIC payload ints."""

    def __init__(self, port: int = 13001, node: str | None = None,
                 timeout: float = 5.0, tls: bool = True):
        self.port = port
        self.node = node
        self.timeout = timeout
        self.tls = tls
        self.session = None        # (sessionid, sessionauth)
        if tls:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False   # self-signed per-test certs
            ctx.verify_mode = ssl.CERT_NONE
            self._sslctx = ctx
        else:
            self._sslctx = None

    def open(self, test, node):
        return RobustIRCClient(self.port, node, self.timeout, self.tls)

    def _ctx(self):
        return self._sslctx

    def _url(self, test, path: str) -> str:
        host, port = resolve(self.node, self.port, test or {})
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{host}:{port}/robustirc/v1{path}"

    def _request(self, test, path: str, body: dict | None = None,
                 method: str = "GET"):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self._url(test, path), data=data, method=method,
            headers={"Content-Type": "application/json",
                     **({"X-Session-Auth": self.session[1]}
                        if self.session else {})})
        return urllib.request.urlopen(req, timeout=self.timeout,
                                      context=self._ctx())

    def _ensure_session(self, test):
        if self.session is None:
            with self._request(test, "/session", {}, "POST") as r:
                out = json.loads(r.read())
            self.session = (out["Sessionid"], out["Sessionauth"])
            for line in (f"NICK j{self.session[0][-6:]}",
                         f"USER jepsen 0 * :jepsen",
                         f"JOIN {CHANNEL}"):
                self._post_message(test, line)

    def _post_message(self, test, line: str) -> None:
        sid = self.session[0]
        self._request(test, f"/{sid}/message",
                      {"Data": line}, "POST").read()

    @staticmethod
    def _topic_payload(data: str) -> str | None:
        """IRC line -> TOPIC payload (filter-topic/extract-topic,
        robustirc.clj:138-148: second token is TOPIC for reflected
        lines, first for raw ones; payload after the last colon)."""
        toks = data.split()
        if len(toks) < 2 or ":" not in data:
            return None
        if toks[0] != "TOPIC" and toks[1] != "TOPIC":
            return None
        return data.rsplit(":", 1)[1].strip()

    def _drain_until(self, test, sentinel: str) -> tuple[list[int], bool]:
        """Stream ndjson messages, collecting TOPIC payload ints, until
        the sentinel topic is seen (-> complete backlog), the server
        closes, or the socket times out (-> partial)."""
        sid = self.session[0]
        vals = []
        complete = False
        try:
            with self._request(test, f"/{sid}/messages?lastseen=0.0"
                               ) as r:
                for raw in r:
                    try:
                        msg = json.loads(raw)
                    except json.JSONDecodeError:
                        continue
                    tail = self._topic_payload(msg.get("Data", ""))
                    if tail is None:
                        continue
                    if tail == sentinel:
                        complete = True
                        break
                    if tail.lstrip("-").isdigit():
                        vals.append(int(tail))
        except (TimeoutError, socket.timeout):
            pass  # long-poll stream: timeout ends the drain early
        return sorted(set(vals)), complete

    def invoke(self, test, op):
        crash = "fail" if op["f"] == "read" else "info"
        try:
            self._ensure_session(test)
            if op["f"] == "add":
                v = int(op["value"])
                self._post_message(test, f"TOPIC {CHANNEL} :{v}")
                return {**op, "type": "ok"}
            if op["f"] == "read":
                # A sentinel topic marks where the backlog ends: a
                # drain that never sees it is partial and must not be
                # reported as a definitive read (set-checker would
                # count committed adds as lost).
                sentinel = f"end-{uuid.uuid4().hex[:12]}"
                self._post_message(test, f"TOPIC {CHANNEL} :{sentinel}")
                seen, complete = self._drain_until(test, sentinel)
                if not complete:
                    return {**op, "type": "fail",
                            "error": "partial-backlog"}
                return {**op, "type": "ok", "value": seen}
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except urllib.error.HTTPError as e:
            self.session = None
            return {**op, "type": "fail" if 400 <= e.code < 500
                    else crash, "error": f"http-{e.code}"}
        except OSError as e:
            self.session = None
            return {**op, "type": crash, "error": str(e)[:160]}


def workloads(opts: dict | None = None) -> dict:
    opts = opts or {}
    std = standard_workloads(opts)
    tls = opts.get("tls", True)

    def set_():
        # message delivery == set semantics: every acknowledged message
        # must be in the final channel history
        return {**std["set"](), "client": RobustIRCClient(tls=tls)}

    # queue has no robustsession client (IRC has no dequeue); it stays
    # pluggable via opts["client"]
    return {"set": set_,
            "queue": lambda: queue_wl.test(opts.get("ops", 500))}


def robustirc_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "set")
    return suite_test(
        "robustirc", wname, opts, workloads(opts),
        db=RobustIRCDB(),
        client=opts.get("client"),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: robustirc_test(
            {**tmap, "workload": resolve_workload(args, tmap, "set")}),
        name="robustirc",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

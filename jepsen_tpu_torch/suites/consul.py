"""Consul suite.

Counterpart of consul/src/jepsen/consul (db.clj's binary install +
`consul agent -server`, client.clj's HTTP KV get/put/cas where CAS
rides the key's ModifyIndex, register.clj's linearizable register
workload). urllib is the whole client — consul's KV API is plain HTTP.

The port's copy of `jepsen_tpu/suites/consul.py`; it imports the
standard library and the port's own modules only. One departure: the
per-key `linear` checker runs on `opts["device"]` (None: cuda), as
`standard_workloads`' register does, so `--device cpu` reaches it.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request

from .. import checker as jchecker
from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import independent, nemesis as jnemesis, os_setup
from ..checker import models
from ..control import util as cutil
from . import base_opts, nemesis_cycle
from .sql import resolve

VERSION = "0.5.2"
DIR = "/opt/consul"
BINARY = f"{DIR}/consul"
PIDFILE = f"{DIR}/consul.pid"
LOGFILE = f"{DIR}/consul.log"
DATA_DIR = f"{DIR}/data"


class ConsulDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """Zip install + `consul agent -server` with node 0 bootstrapping
    and the rest joining it (db.clj:23-52); kill/pause fault protocols
    via SignalProcess."""

    process_pattern = "consul"

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, sess, test, node):
        nodes = test.get("nodes", [node])
        args = [BINARY, "agent", "-server",
                "-data-dir", DATA_DIR,
                "-bind", node, "-client", "0.0.0.0",
                "-node", node]
        if node == nodes[0]:
            args += ["-bootstrap-expect", str(len(nodes))]
        else:
            args += ["-retry-join", nodes[0]]
        cutil.start_daemon(sess, *args, logfile=LOGFILE,
                           pidfile=PIDFILE, chdir=DIR)

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://releases.hashicorp.com/consul/{self.version}/"
               f"consul_{self.version}_linux_amd64.zip")
        cutil.install_archive(sess, url, DIR)
        self._start(sess, test, node)

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [LOGFILE]


class ConsulClient(jclient.Client):
    """KV register over the HTTP API (client.clj:48-88): reads return
    (value, ModifyIndex); `?cas=index` makes the put conditional."""

    def __init__(self, port: int = 8500, node: str | None = None,
                 timeout: float = 5.0):
        self.port = port
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return ConsulClient(self.port, node, self.timeout)

    def _url(self, test, k, query: str = "") -> str:
        host, port = resolve(self.node, self.port, test or {})
        return f"http://{host}:{port}/v1/kv/jepsen-r{k}{query}"

    def _get(self, test, k):
        """-> (value | None, modify_index)."""
        try:
            with urllib.request.urlopen(self._url(test, k),
                                        timeout=self.timeout) as r:
                body = json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None, 0
            raise
        entry = body[0]
        raw = entry.get("Value")
        val = int(base64.b64decode(raw)) if raw else None
        return val, int(entry.get("ModifyIndex", 0))

    def _put(self, test, k, val, cas_index: int | None = None) -> bool:
        q = f"?cas={cas_index}" if cas_index is not None else ""
        req = urllib.request.Request(
            self._url(test, k, q), data=str(int(val)).encode(),
            method="PUT")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read()) is True

    def invoke(self, test, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        crash = "fail" if op["f"] == "read" else "info"
        try:
            if op["f"] == "read":
                cur, _idx = self._get(test, k)
                return {**op, "type": "ok", "value": lift(cur)}
            if op["f"] == "write":
                self._put(test, k, val)
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = val
                cur, idx = self._get(test, k)
                if cur != old:
                    return {**op, "type": "fail", "error": "precondition"}
                if self._put(test, k, new, cas_index=idx):
                    return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": "cas-index"}
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except urllib.error.HTTPError as e:
            if 400 <= e.code < 500:
                return {**op, "type": "fail", "error": f"http-{e.code}"}
            return {**op, "type": crash, "error": f"http-{e.code}"}
        except OSError as e:
            return {**op, "type": crash, "error": str(e)[:160]}


def workloads(opts: dict | None = None) -> dict:
    from ..workloads.register import rand_op
    opts = opts or {}

    def register():
        return {
            "generator": independent.concurrent_generator(
                2, range(10_000),
                lambda k: gen.limit(100, rand_op)),
            "checker": independent.checker(jchecker.compose({
                "timeline": jchecker.timeline_checker(),
                "linear": jchecker.linearizable(
                    models.cas_register(), device=opts.get("device")),
            })),
        }

    return {"register": register}


def consul_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wl = workloads(opts)["register"]()
    test = {
        "name": "consul register",
        "os": os_setup.debian(),
        "db": ConsulDB(opts.get("version", VERSION)),
        "client": opts.get("client") or ConsulClient(),
        "nemesis": jnemesis.partition_random_halves(),
        "checker": wl["checker"],
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(wl["generator"],
                        nemesis_cycle(opts.get("nemesis-interval", 10)))),
        "workload": "register",
    }
    for k, v in opts.items():
        test.setdefault(k, v)
    return test


def main(argv=None) -> int:
    return jcli.run_cli(lambda tmap, args: consul_test(tmap),
                        name="consul", argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

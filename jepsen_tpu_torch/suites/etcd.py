"""The etcd suite — the canonical small per-DB suite, and config #1 of
the north-star benchmark (BASELINE.json).

Counterpart of etcd/src/jepsen/etcd.clj: installs etcd from the release
tarball on each node (db, etcd.clj:51-86), drives a compare-and-set
register per key over etcd's HTTP API (client, etcd.clj:93-143), lifts
it over independent keys with 10 threads/key, 300 ops/key, stagger 1/30s
(etcd-test, etcd.clj:154-180), partitions random halves every 10s, and
checks per-key linearizability plus timelines and perf plots.

The port's copy of `jepsen_tpu/suites/etcd.py`; it imports the
standard library and the port's own modules only. One departure: the
per-key `linear` checker runs on `opts["device"]` (None: cuda), as
`standard_workloads`' register does, so `--device cpu` reaches it.
"""

from __future__ import annotations

import json
import random
import urllib.error
import urllib.parse
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

VERSION = "v3.1.5"
DIR = "/opt/etcd"
BINARY = f"{DIR}/etcd"
LOGFILE = f"{DIR}/etcd.log"
PIDFILE = f"{DIR}/etcd.pid"


def node_url(node: str, port: int) -> str:
    return f"http://{node}:{port}"


def peer_url(node: str) -> str:
    return node_url(node, 2380)


def client_url(node: str) -> str:
    return node_url(node, 2379)


def initial_cluster(test: dict) -> str:
    """\"n1=http://n1:2380,n2=...\" (etcd.clj:42-49)."""
    return ",".join(f"{n}={peer_url(n)}" for n in test.get("nodes", []))


class EtcdDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """Tarball install + daemonized etcd (db, etcd.clj:51-86);
    kill/pause fault protocols (db.clj:22-35) via SignalProcess."""

    process_pattern = "etcd"

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, sess, test, node):
        cutil.start_daemon(
            sess, BINARY,
            "--name", node,
            "--listen-peer-urls", peer_url(node),
            "--listen-client-urls", client_url(node),
            "--advertise-client-urls", client_url(node),
            "--initial-cluster-state", "new",
            "--initial-advertise-peer-urls", peer_url(node),
            "--initial-cluster", initial_cluster(test),
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def setup(self, test, node):
        sess = control.current_session()
        url = (f"https://storage.googleapis.com/etcd/{self.version}/"
               f"etcd-{self.version}-linux-amd64.tar.gz")
        cutil.install_archive(sess.su(), url, DIR)
        self._start(sess.su(), test, node)
        import time
        time.sleep(5)

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [LOGFILE]


class EtcdClient(jclient.Client):
    """CAS register over etcd's v2 HTTP API (client, etcd.clj:93-143).
    Ops take independent-lifted values [k, v]."""

    def __init__(self, node: str | None = None, timeout: float = 5.0,
                 quorum: bool = False):
        # quorum=False matches the reference client (etcd.clj:108) — the
        # non-quorum reads are exactly what lets the linearizability
        # checker expose etcd's stale reads. Pass quorum=True for a
        # configuration the checker should find valid.
        self.node = node
        self.timeout = timeout
        self.quorum = quorum

    def open(self, test, node):
        return EtcdClient(node, self.timeout, self.quorum)

    def _url(self, k) -> str:
        return f"{client_url(self.node)}/v2/keys/r{k}"

    def _request(self, url: str, data: dict | None = None,
                 method: str = "GET"):
        body = urllib.parse.urlencode(data).encode() if data else None
        req = urllib.request.Request(url, data=body, method=method)
        if body:
            req.add_header("Content-Type",
                           "application/x-www-form-urlencoded")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def invoke(self, test, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (v, None)
        crash = "fail" if op["f"] == "read" else "info"
        try:
            if op["f"] == "read":
                q = "true" if self.quorum else "false"
                out = self._request(self._url(k) + f"?quorum={q}")
                read = out.get("node", {}).get("value")
                read = int(read) if read is not None else None
                return {**op, "type": "ok",
                        "value": independent.tuple_(k, read)}
            if op["f"] == "write":
                self._request(self._url(k), {"value": val}, "PUT")
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = val
                try:
                    self._request(
                        self._url(k) + f"?prevValue={old}&prevExist=true",
                        {"value": new}, "PUT")
                    return {**op, "type": "ok"}
                except urllib.error.HTTPError as e:
                    if e.code in (404, 412):  # not found / compare failed
                        return {**op, "type": "fail",
                                "error": "precondition"}
                    raise
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return {**op, "type": "fail", "error": "not-found"}
            return {**op, "type": crash, "error": f"http-{e.code}"}
        except OSError as e:  # timeouts, refused connections, DNS
            return {**op, "type": crash, "error": str(e)}


def r(test=None, ctx=None):
    return {"type": "invoke", "f": "read", "value": None}


def w(test=None, ctx=None):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def cas(test=None, ctx=None):
    return {"type": "invoke", "f": "cas",
            "value": [random.randint(0, 4), random.randint(0, 4)]}


def workloads(opts: dict | None = None) -> dict:
    """Registry-uniform view: etcd is the single canonical CAS-register
    suite (etcd.clj:149-180)."""
    opts = opts or {}

    def register():
        t = etcd_test(opts)
        return {"generator": t["generator"], "checker": t["checker"]}

    return {"register": register}


def etcd_test(opts: dict | None = None) -> dict:
    """Full test map (etcd-test, etcd.clj:150-180)."""
    opts = base_opts(**(opts or {}))
    ops_per_key = opts.get("ops-per-key", 300)
    threads_per_key = opts.get("threads-per-key", 10)
    db = EtcdDB(opts.get("version", VERSION))
    interval = opts.get("nemesis-interval", 10)
    nemesis = jnemesis.partition_random_halves()
    nemesis_gen = nemesis_cycle(interval)
    if opts.get("faults"):
        from ..nemesis import combined as ncombined
        pkg = ncombined.nemesis_package(db, interval,
                                        faults=opts["faults"])
        nemesis = pkg["nemesis"]
        if pkg.get("generator") is not None:
            nemesis_gen = pkg["generator"]
    test = {
        "name": "etcd",
        "os": os_setup.debian(),
        "db": db,
        "client": EtcdClient(quorum=bool(opts.get("quorum", False))),
        "nemesis": nemesis,
        "checker": jchecker.compose({
            "perf": jchecker.perf_checker(),
            "indep": independent.checker(jchecker.compose({
                "timeline": jchecker.timeline_checker(),
                "linear": jchecker.linearizable(
                    models.cas_register(),
                    device=opts.get("device")),
            })),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(
                independent.concurrent_generator(
                    threads_per_key, range(100000),
                    lambda k: gen.limit(
                        ops_per_key,
                        gen.stagger(1 / 30, gen.mix([r, w, cas])))),
                nemesis_gen)),
    }
    for k, v in opts.items():
        test.setdefault(k, v)
    return test


def main(argv=None) -> int:
    """CLI entry: test / analyze / serve (etcd.clj:182-191)."""
    return jcli.run_cli(lambda tmap, args: etcd_test(tmap), argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

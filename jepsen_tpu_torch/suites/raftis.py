"""Raftis suite.

Counterpart of raftis/src/jepsen/raftis.clj (142 LoC): a
redis-protocol store replicated over raft, driven with plain SET/GET
register ops (the reference has no CAS — raftis doesn't expose one,
raftis.clj:20-21,39-47) and checked for per-key linearizability. The
client is the in-tree RESP driver.

The port's copy of `jepsen_tpu/suites/raftis.py`; it imports the
standard library and the port's own modules only. One departure: the
register workload's `linearizable` checker runs on `opts["device"]`
(None: cuda), as `standard_workloads`' register does, so `--device
cpu` reaches it.
"""

from __future__ import annotations

import random

from .. import checker as jchecker
from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import independent, nemesis as jnemesis, os_setup
from ..checker import models
from ..control import util as cutil
from ..drivers import DBError, DriverError
from . import base_opts, nemesis_cycle
from .sql import resolve

DIR = "/opt/raftis"
PORT = 6379
PIDFILE = f"{DIR}/raftis.pid"
LOGFILE = f"{DIR}/raftis.log"


class RaftisDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """go build + daemonize with the peer list (db, raftis.clj:79-110);
    kill/pause fault protocols via SignalProcess."""

    process_pattern = "raftis"

    def _start(self, sess, test, node):
        nodes = test.get("nodes", [node])
        cluster = ",".join(f"{n}:{PORT}" for n in nodes)
        cutil.start_daemon(
            sess, f"{DIR}/raftis",
            "-hosts", cluster,
            "-bind", f"{node}:{PORT}",
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("sh", "-c",
                  f"test -d {DIR} || git clone "
                  f"https://github.com/goraft/raftis {DIR}")
        sess.exec("sh", "-c", f"cd {DIR} && go build -o raftis .")
        self._start(sess, test, node)

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", f"{DIR}/data")

    def log_files(self, test, node):
        return [LOGFILE]


class RaftisClient(jclient.Client):
    """SET/GET register over RESP (client, raftis.clj:28-52); NOLEADER
    errors are definite fails, timeouts indeterminate for writes."""

    def __init__(self, port: int = PORT, node: str | None = None,
                 timeout: float = 5.0):
        self.port = port
        self.node = node
        self.timeout = timeout
        self.conn = None

    def open(self, test, node):
        return RaftisClient(self.port, node, self.timeout)

    def _ensure_conn(self, test):
        if self.conn is None:
            from ..drivers import resp
            host, port = resolve(self.node, self.port, test or {})
            self.conn = resp.connect(host, port, self.timeout)

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def invoke(self, test, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        read_only = op["f"] == "read"
        try:
            self._ensure_conn(test)
            if op["f"] == "read":
                out = self.conn.command("GET", f"r{k}")
                return {**op, "type": "ok",
                        "value": lift(int(out) if out else None)}
            if op["f"] == "write":
                self.conn.command("SET", f"r{k}", int(val))
                return {**op, "type": "ok"}
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except DBError as e:
            # NOLEADER / MOVED style rejections are definite
            return {**op, "type": "fail",
                    "error": f"raftis-{e.code}: {e.message[:120]}"}
        except (DriverError, OSError) as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}


def r(test=None, ctx=None):
    return {"type": "invoke", "f": "read", "value": None}


def w(test=None, ctx=None):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def workloads(opts: dict | None = None) -> dict:
    def register():
        return {
            "generator": independent.concurrent_generator(
                2, range(10_000),
                lambda k: gen.limit(100, gen.mix([r, w]))),
            "checker": independent.checker(
                jchecker.linearizable(models.register(),
                                      device=(opts or {}).get("device"))),
        }

    return {"register": register}


def raftis_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wl = workloads(opts)["register"]()
    test = {
        "name": "raftis register",
        "os": os_setup.debian(),
        "db": RaftisDB(),
        "client": opts.get("client") or RaftisClient(),
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
    return jcli.run_cli(lambda tmap, args: raftis_test(tmap),
                        name="raftis", argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

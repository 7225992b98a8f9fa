"""RethinkDB suite.

Counterpart of rethinkdb/src/jepsen/rethinkdb (529 LoC): apt-installed
RethinkDB with a joined cluster, driven over the ReQL wire protocol
directly (drivers.reql — V1_0 SCRAM handshake + JSON term queries)
with hard durability and majority reads, the write_acks=majority shape
the reference tests.

The port's copy of `jepsen_tpu/suites/rethinkdb.py`; it imports the
standard library and the port's own modules only. One departure: the
register workload's checker runs its `linearizable` on `opts["device"]`
(None: cuda), as `standard_workloads`' register does, so `--device
cpu` reaches it.
"""

from __future__ import annotations

from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import independent, nemesis as jnemesis, os_setup
from ..checker import models
from ..drivers import DBError, DriverError
from ..workloads import set_workload
from . import base_opts, suite_test
from .sql import resolve

LOGFILE = "/var/log/rethinkdb.log"


class RethinkDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """apt repo + service, joining node 0 (install!/start!,
    rethinkdb.clj:52-100); kill/pause fault protocols via
    SignalProcess."""

    process_pattern = "rethinkdb"

    def __init__(self, version: str = "2.3.4~0jessie"):
        self.version = version

    def _start(self, sess, test, node):
        sess.exec("service", "rethinkdb", "start")

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("sh", "-c",
                  "wget -qO- https://download.rethinkdb.com/apt/"
                  "pubkey.gpg | apt-key add -")
        sess.exec("sh", "-c",
                  'echo "deb https://download.rethinkdb.com/apt '
                  'jessie main" > /etc/apt/sources.list.d/rethinkdb.list')
        sess.exec("apt-get", "update")
        sess.exec("apt-get", "install", "-y",
                  f"rethinkdb={self.version}")
        nodes = test.get("nodes", [node])
        cfg = "\n".join([f"bind=all", f"server-name={node}",
                         f"join={nodes[0]}:29015"])
        sess.exec("sh", "-c",
                  f"cat > /etc/rethinkdb/instances.d/jepsen.conf "
                  f"<< 'EOF'\n{cfg}\nEOF")
        sess.exec("service", "rethinkdb", "start")

    def teardown(self, test, node):
        sess = control.current_session().su()
        sess.exec_ok("service", "rethinkdb", "stop")
        sess.exec("rm", "-rf", "/var/lib/rethinkdb")

    def log_files(self, test, node):
        return [LOGFILE]


DB_NAME = "jepsen"


class RethinkClient(jclient.Client):
    """Document ops over ReQL: reads are majority-read GETs, writes are
    hard-durability inserts with conflict replace — the write-then-
    read-your-majority shape the reference's register workload uses.
    (CAS needs ReQL lambda terms; the reference sweeps r/w too.)"""

    def __init__(self, mode: str = "register", port: int = 28015,
                 node: str | None = None, timeout: float = 5.0):
        self.mode = mode
        self.port = port
        self.node = node
        self.timeout = timeout
        self.conn = None
        self._setup_done = False

    def open(self, test, node):
        return RethinkClient(self.mode, self.port, node, self.timeout)

    def _ensure_conn(self, test):
        if self.conn is None:
            from ..drivers import reql
            host, port = resolve(self.node, self.port, test or {})
            self.conn = reql.connect(host, port, timeout=self.timeout)
        if not self._setup_done:
            self.conn.db_create(DB_NAME)
            for tbl in ("registers", "sets"):
                self.conn.table_create(DB_NAME, tbl)
            self._setup_done = True

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def invoke(self, test, op):
        read_only = op.get("f") == "read"
        try:
            self._ensure_conn(test)
            if self.mode == "set":
                return self._set(op)
            return self._register(op)
        except DBError as e:
            return {**op, "type": "fail",
                    "error": f"reql-{e.code}: {e.message[:120]}"}
        except (DriverError, OSError) as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}

    def _register(self, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        c = self.conn
        if op["f"] == "read":
            doc = c.get(DB_NAME, "registers", int(k))
            out = doc.get("val") if isinstance(doc, dict) else None
            return {**op, "type": "ok", "value": lift(out)}
        if op["f"] == "write":
            c.insert(DB_NAME, "registers",
                     {"id": int(k), "val": int(val)},
                     conflict="replace", durability="hard")
            return {**op, "type": "ok"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _set(self, op):
        c = self.conn
        if op["f"] == "add":
            c.insert(DB_NAME, "sets", {"id": int(op["value"])},
                     conflict="error", durability="hard")
            return {**op, "type": "ok"}
        if op["f"] == "read":
            docs = c.run(c.table(DB_NAME, "sets"),
                         {"read_mode": "majority"})
            return {**op, "type": "ok",
                    "value": sorted(int(d["id"]) for d in docs)}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}


def workloads(opts: dict | None = None) -> dict:
    opts = opts or {}
    from ..workloads import register as register_wl
    from ..workloads.register import r, w

    def register():
        # cas-less mix: ReQL updates are last-write-wins documents
        return {
            "generator": register_wl.generator(2, 10_000, 100,
                                               ops=[r, w]),
            "checker": register_wl.checker(model=models.register(),
                                           device=opts.get("device")),
            "client": RethinkClient("register"),
        }

    def set_():
        wl = set_workload.test(n=opts.get("set-size", 500))
        return {**wl, "client": RethinkClient("set")}

    return {"register": register, "set": set_}


def rethinkdb_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "register")
    return suite_test(
        "rethinkdb", wname, opts, workloads(opts),
        db=RethinkDB(opts.get("version", "2.3.4~0jessie")),
        client=opts.get("client"),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: rethinkdb_test(
            {**tmap,
             "workload": resolve_workload(args, tmap, "register")}),
        name="rethinkdb",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

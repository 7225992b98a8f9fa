"""MongoDB suite core: replica-set install + document-CAS clients.

Counterpart of the mongodb-rocks and mongodb-smartos suites
(mongodb-rocks/src/jepsen/mongodb_rocks.clj 169 LoC — a storage-engine
variant; mongodb-smartos 788 LoC — an OS variant). Both share this
module's DB (tarball mongod, one replica set, rs.initiate from node 0
over the wire protocol) and client (findAndModify document CAS with
majority write concern, majority-read register reads).

The port's copy of `jepsen_tpu/suites/mongodb.py`; it imports the
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
from ..workloads import set_workload
from . import base_opts, nemesis_cycle
from .sql import resolve

VERSION = "3.4.1"
DIR = "/opt/mongodb"
PIDFILE = f"{DIR}/mongod.pid"
LOGFILE = f"{DIR}/mongod.log"
PORT = 27017
RS = "jepsen"

MAJORITY = {"w": "majority"}


class MongoDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """Tarball mongod with --replSet; node 0 initiates the set over
    the wire protocol once every member is up. kill/pause fault
    protocols via SignalProcess."""

    process_pattern = "mongod"

    def __init__(self, version: str = VERSION,
                 storage_engine: str = "wiredTiger"):
        self.version = version
        self.storage_engine = storage_engine

    def _start(self, sess, test, node):
        cutil.start_daemon(
            sess, f"{DIR}/bin/mongod",
            "--dbpath", f"{DIR}/data",
            "--bind_ip", node,
            "--port", str(PORT),
            "--replSet", RS,
            "--storageEngine", self.storage_engine,
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://fastdl.mongodb.org/linux/"
               f"mongodb-linux-x86_64-{self.version}.tgz")
        cutil.install_archive(sess, url, DIR)
        sess.exec("mkdir", "-p", f"{DIR}/data")
        self._start(sess, test, node)
        nodes = test.get("nodes", [node])
        dummy = bool(test.get("ssh", {}).get("dummy"))
        if node == nodes[0] and not dummy:
            # Setups run in parallel across nodes — retry until every
            # member answers (a fixed sleep races the slowest install;
            # mongod rejects replSetInitiate until peers are up).
            import time

            from ..drivers import DriverError, mongo
            members = [{"_id": i, "host": f"{n}:{PORT}"}
                       for i, n in enumerate(nodes)]
            last: Exception | None = None
            for _ in range(60):
                try:
                    conn = mongo.connect(node, PORT, database="admin")
                    try:
                        conn.command({"replSetInitiate":
                                      {"_id": RS, "members": members}})
                        return
                    finally:
                        conn.close()
                except DBError as e:
                    if "already initialized" in e.message:
                        return
                    last = e
                except (DriverError, OSError) as e:
                    last = e
                time.sleep(1)
            raise RuntimeError(f"replSetInitiate never succeeded: {last}")

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", f"{DIR}/data")

    def log_files(self, test, node):
        return [LOGFILE]


class MongoClient(jclient.Client):
    """Document CAS register (the reference's findAndModify shape) and
    set-adds, all with majority write concern."""

    def __init__(self, mode: str = "register", port: int = PORT,
                 node: str | None = None, timeout: float = 5.0):
        self.mode = mode
        self.port = port
        self.node = node
        self.timeout = timeout
        self.conn = None

    def open(self, test, node):
        return MongoClient(self.mode, self.port, node, self.timeout)

    def _ensure_conn(self, test):
        if self.conn is None:
            from ..drivers import mongo
            host, port = resolve(self.node, self.port, test or {})
            self.conn = mongo.connect(host, port, database="jepsen",
                                      timeout=self.timeout)

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def invoke(self, test, op):
        read_only = op["f"] == "read"
        try:
            self._ensure_conn(test)
            if self.mode == "set":
                return self._set(op)
            return self._register(op)
        except DBError as e:
            return {**op, "type": "fail",
                    "error": f"mongo-{e.code}: {e.message[:120]}"}
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
            docs = c.find("registers", {"_id": int(k)},
                          read_concern={"level": "majority"})
            out = docs[0].get("value") if docs else None
            return {**op, "type": "ok", "value": lift(out)}
        if op["f"] == "write":
            c.update("registers", {"_id": int(k)},
                     {"$set": {"value": int(val)}}, upsert=True,
                     write_concern=MAJORITY)
            return {**op, "type": "ok"}
        if op["f"] == "cas":
            old, new = val
            reply = c.find_and_modify(
                "registers", {"_id": int(k), "value": int(old)},
                {"$set": {"value": int(new)}},
                write_concern=MAJORITY)
            if reply.get("value") is None:
                return {**op, "type": "fail", "error": "precondition"}
            return {**op, "type": "ok"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _set(self, op):
        c = self.conn
        if op["f"] == "add":
            c.insert("sets", [{"_id": int(op["value"])}],
                     write_concern=MAJORITY)
            return {**op, "type": "ok"}
        if op["f"] == "read":
            docs = c.find("sets", {},
                          read_concern={"level": "majority"})
            return {**op, "type": "ok",
                    "value": sorted(int(d["_id"]) for d in docs)}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}


def r(test=None, ctx=None):
    return {"type": "invoke", "f": "read", "value": None}


def w(test=None, ctx=None):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def cas(test=None, ctx=None):
    return {"type": "invoke", "f": "cas",
            "value": [random.randint(0, 4), random.randint(0, 4)]}


def workloads(opts: dict | None = None) -> dict:
    opts = opts or {}

    def register():
        return {
            "generator": independent.concurrent_generator(
                2, range(10_000),
                lambda k: gen.limit(100, gen.mix([r, w, cas]))),
            "checker": independent.checker(
                jchecker.linearizable(models.cas_register(),
                                      device=opts.get("device"))),
            "client": MongoClient("register"),
        }

    def set_():
        wl = set_workload.test(n=opts.get("set-size", 500))
        return {**wl, "client": MongoClient("set")}

    return {"register": register, "set": set_}


def mongodb_test(opts: dict | None = None, name: str = "mongodb",
                 storage_engine: str = "wiredTiger",
                 os_module=None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "register")
    wl = workloads(opts)[wname]()
    test = {
        "name": f"{name} {wname}",
        "os": os_module or os_setup.debian(),
        "db": MongoDB(opts.get("version", VERSION), storage_engine),
        "client": opts.get("client") or wl["client"],
        "nemesis": jnemesis.partition_random_halves(),
        "checker": wl["checker"],
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(wl["generator"],
                        nemesis_cycle(opts.get("nemesis-interval", 10)))),
        "workload": wname,
    }
    for k, v in opts.items():
        test.setdefault(k, v)
    return test


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: mongodb_test(
            {**tmap,
             "workload": resolve_workload(args, tmap, "register")}),
        name="mongodb",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

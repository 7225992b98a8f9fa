"""ZooKeeper suite.

Counterpart of zookeeper/src/jepsen/zookeeper.clj (137 LoC, the
smallest real suite): apt-installed ZooKeeper with per-node myid +
zoo.cfg (zookeeper.clj:20-60), a CAS register per key over znode
versions, and a per-key linearizability check. The client speaks the
jute wire protocol directly (drivers.zk) instead of avout:
getData returns the znode version, setData with that version is the
CAS.

The port's copy of `jepsen_tpu/suites/zookeeper.py`; it imports the
standard library and the port's own modules only. One departure: the
per-key `linear` checker runs on `opts["device"]` (None: cuda), as
`standard_workloads`' register does, so `--device cpu` reaches it.
"""

from __future__ import annotations


from .. import checker as jchecker
from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import independent, nemesis as jnemesis, os_setup
from ..checker import models
from ..drivers import DBError, DriverError
from . import base_opts, nemesis_cycle
from .sql import resolve

VERSION = "3.4.13-2"
CFG = "/etc/zookeeper/conf"


def node_ids(test: dict) -> dict:
    return {n: i for i, n in enumerate(test.get("nodes", []))}


def zoo_cfg(test: dict) -> str:
    """zoo.cfg body (zoo-cfg-servers, zookeeper.clj:32-38)."""
    lines = [
        "tickTime=2000", "initLimit=10", "syncLimit=5",
        "dataDir=/var/lib/zookeeper", "clientPort=2181",
    ]
    lines += [f"server.{i}={n}:2888:3888"
              for n, i in node_ids(test).items()]
    return "\n".join(lines)


class ZookeeperDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """apt install + myid + zoo.cfg + service restart
    (db, zookeeper.clj:40-66); kill/pause fault protocols via
    SignalProcess."""

    process_pattern = "zookeeper"

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, sess, test, node):
        sess.exec("service", "zookeeper", "start")

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("apt-get", "install", "-y",
                  f"zookeeper={self.version}",
                  f"zookeeper-bin={self.version}",
                  f"zookeeperd={self.version}")
        sess.exec("sh", "-c",
                  f"echo {node_ids(test)[node]} > {CFG}/myid")
        sess.exec("sh", "-c",
                  f"cat > {CFG}/zoo.cfg << 'EOF'\n{zoo_cfg(test)}\nEOF")
        sess.exec("service", "zookeeper", "restart")

    def teardown(self, test, node):
        sess = control.current_session().su()
        sess.exec_ok("service", "zookeeper", "stop")
        sess.exec("rm", "-rf", "/var/lib/zookeeper/version-2")

    def log_files(self, test, node):
        return ["/var/log/zookeeper/zookeeper.log"]


class ZKClient(jclient.Client):
    """CAS register per key over znode data versions."""

    def __init__(self, port: int = 2181, node: str | None = None,
                 timeout: float = 5.0):
        self.port = port
        self.node = node
        self.timeout = timeout
        self.conn = None

    def open(self, test, node):
        return ZKClient(self.port, node, self.timeout)

    def _ensure_conn(self, test):
        if self.conn is None:
            from ..drivers import zk
            host, port = resolve(self.node, self.port, test or {})
            self.conn = zk.connect(host, port, self.timeout)

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def _path(self, k) -> str:
        return f"/jepsen-r{k}"

    def invoke(self, test, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        read_only = op["f"] == "read"
        try:
            self._ensure_conn(test)
            c = self.conn
            if op["f"] == "read":
                try:
                    data, _stat = c.get_data(self._path(k))
                except DBError as e:
                    if e.code == "no-node":
                        return {**op, "type": "ok", "value": lift(None)}
                    raise
                return {**op, "type": "ok",
                        "value": lift(int(data) if data else None)}
            if op["f"] == "write":
                try:
                    c.set_data(self._path(k), str(int(val)).encode())
                except DBError as e:
                    if e.code != "no-node":
                        raise
                    try:
                        c.create(self._path(k), str(int(val)).encode())
                    except DBError as e2:
                        if e2.code != "node-exists":
                            raise
                        c.set_data(self._path(k), str(int(val)).encode())
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = val
                try:
                    data, stat = c.get_data(self._path(k))
                except DBError as e:
                    if e.code == "no-node":
                        return {**op, "type": "fail", "error": "no-node"}
                    raise
                cur = int(data) if data else None
                if cur != old:
                    return {**op, "type": "fail", "error": "precondition"}
                try:
                    # version-guarded write: the znode CAS primitive
                    c.set_data(self._path(k), str(int(new)).encode(),
                               version=stat.version)
                except DBError as e:
                    if e.code == "bad-version":
                        return {**op, "type": "fail",
                                "error": "bad-version"}
                    raise
                return {**op, "type": "ok"}
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except DBError as e:
            return {**op, "type": "fail",
                    "error": f"zk-{e.code}: {e.message[:120]}"}
        except (DriverError, OSError) as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}


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


def zookeeper_test(opts: dict | None = None) -> dict:
    """Full test map (zk-test, zookeeper.clj:120-137)."""
    opts = base_opts(**(opts or {}))
    wl = workloads(opts)["register"]()
    test = {
        "name": "zookeeper register",
        "os": os_setup.debian(),
        "db": ZookeeperDB(opts.get("version", VERSION)),
        "client": opts.get("client") or ZKClient(),
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
    return jcli.run_cli(lambda tmap, args: zookeeper_test(tmap),
                        name="zookeeper", argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

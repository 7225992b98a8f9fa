"""Hazelcast suite.

Counterpart of hazelcast/src/jepsen/hazelcast.clj (821 LoC + the
SetUnionMergePolicy.java server extension): an embedded-jar server
started per node with a TCP/IP member list, driven over the Open
Client Protocol (drivers/hazelcast_proto.py) through the reference's
distinctive workload menu — locks (+ the no-quorum variant,
hazelcast.clj:412-449 & 652-677), queues with total-queue accounting
(270-296, 756), atomic-long unique ids (146-161, 766-770), and the
map/crdt-map set-union CAS workloads that exercise the shipped
SetUnionMergePolicy (453-509).

The port's copy of `jepsen_tpu/suites/hazelcast.py`; it imports the
standard library and the port's own modules only. One departure: the
lock workloads' `linearizable` mutex checker runs on `opts["device"]`
(None: cuda), as `standard_workloads`' register does, so `--device
cpu` reaches it. DB setup uploads the port's own copy of
`resources/SetUnionMergePolicy.java`, which lies beside this module.
"""

from __future__ import annotations

from .. import checker as jchecker
from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis, os_setup
from ..checker import models
from ..control import util as cutil
from ..drivers import DriverError
from ..drivers import hazelcast_proto as hz
from ..workloads import queue as queue_wl
from . import base_opts, suite_test

DIR = "/opt/hazelcast"
VERSION = "3.10.3"
PIDFILE = f"{DIR}/hazelcast.pid"
LOGFILE = f"{DIR}/hazelcast.log"


class HazelcastDB(jdb.DB, jdb.LogFiles):
    """jar download + java -jar server with tcp-ip join config
    (install!/db, hazelcast.clj:69-110)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        sess = control.current_session().su()
        # jdk, not jre: the merge policy compiles on node (javac)
        sess.exec("apt-get", "install", "-y", "openjdk-8-jdk-headless")
        sess.exec("mkdir", "-p", DIR)
        url = (f"https://repo1.maven.org/maven2/com/hazelcast/hazelcast/"
               f"{self.version}/hazelcast-{self.version}.jar")
        sess.exec("sh", "-c",
                  f"test -f {DIR}/hazelcast.jar || "
                  f"wget -qO {DIR}/hazelcast.jar {url}")
        nodes = test.get("nodes", [node])
        members = "\n".join(
            f"          <member>{n}</member>" for n in nodes)
        cfg = ("<hazelcast xmlns=\"http://www.hazelcast.com/schema/"
               "config\">\n  <network>\n    <port>5701</port>\n"
               "    <join>\n      <multicast enabled=\"false\"/>\n"
               "      <tcp-ip enabled=\"true\">\n"
               f"{members}\n      </tcp-ip>\n    </join>\n"
               "  </network>\n"
               # split-brain heals by set union on the workload maps —
               # without this registration the policy is never invoked
               "  <map name=\"jepsen*\">\n"
               "    <merge-policy>jepsen.tpu.hazelcast."
               "SetUnionMergePolicy</merge-policy>\n"
               "  </map>\n</hazelcast>\n")
        sess.exec("sh", "-c",
                  f"cat > {DIR}/hazelcast.xml << 'EOF'\n{cfg}\nEOF")
        # server-side split-brain merge policy for the CRDT set
        # workload (resources/SetUnionMergePolicy.java) — compiled on
        # node like the reference's server extension
        import os.path as _p
        src = _p.join(_p.dirname(__file__), "resources",
                      "SetUnionMergePolicy.java")
        plain = control.current_session()
        plain.upload(src, "/tmp/SetUnionMergePolicy.java")
        sess.exec("mkdir", "-p",
                  f"{DIR}/classes/jepsen/tpu/hazelcast")
        # loud failure: a missing policy would silently change the
        # split-brain semantics the set workload tests
        sess.exec("sh", "-c",
                  f"cd /tmp && javac -cp {DIR}/hazelcast.jar "
                  f"-d {DIR}/classes SetUnionMergePolicy.java")
        cutil.start_daemon(
            sess, "java",
            f"-Dhazelcast.config={DIR}/hazelcast.xml",
            "-cp", f"{DIR}/hazelcast.jar:{DIR}/classes",
            "com.hazelcast.core.server.StartServer",
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# wire clients (hazelcast.clj:146-161, 270-296, 412-449, 453-509)
# ---------------------------------------------------------------------------

class _HzClient(jclient.Client):
    """Shared connection plumbing: one HzConn per open, DriverError ->
    indeterminate for mutations (the reference's IOException handling,
    hazelcast.clj:439-446)."""

    port = 5701

    def __init__(self, conn: hz.HzConn | None = None,
                 port: int | None = None):
        self.conn = conn
        if port is not None:
            self.port = port

    def _open(self, node: str) -> hz.HzConn:
        return hz.HzConn(node, self.port)

    def open(self, test, node):
        c = type(self)(self._open(node), port=self.port)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


class LockClient(_HzClient):
    """ILock acquire/release (lock-client, hazelcast.clj:412-449):
    acquire = tryLock(5s) -> ok/fail; release = unlock, with
    not-lock-owner and quorum failures classified like the reference."""

    lock_name = "jepsen.lock"

    def __init__(self, conn=None, port=None, lock_name=None):
        super().__init__(conn, port)
        if lock_name is not None:
            self.lock_name = lock_name

    def open(self, test, node):
        c = type(self)(self._open(node), port=self.port,
                       lock_name=self.lock_name)
        return c

    def invoke(self, test, op):
        try:
            if op["f"] == "acquire":
                ok = self.conn.lock_try_lock(self.lock_name, 5000)
                return {**op, "type": "ok" if ok else "fail"}
            if op["f"] == "release":
                self.conn.lock_unlock(self.lock_name)
                return {**op, "type": "ok"}
            return {**op, "type": "fail", "error": f"bad f {op['f']!r}"}
        except hz.HazelcastError as e:
            msg = str(e)
            if "not owner of the lock" in msg or \
                    "IllegalMonitorStateException" in msg:
                return {**op, "type": "fail", "error": "not-lock-owner"}
            if "QuorumException" in msg:
                return {**op, "type": "fail", "error": "quorum"}
            raise
        except DriverError as e:
            # acquire that never reached the cluster still may have:
            # indeterminate either way (a lost unlock matters too)
            return {**op, "type": "info", "error": str(e)[:120]}


class QueueClient(_HzClient):
    """IQueue enqueue/dequeue/drain with total-queue accounting
    (queue-client, hazelcast.clj:270-296)."""

    queue_name = "jepsen.queue"

    def invoke(self, test, op):
        try:
            if op["f"] == "enqueue":
                ok = self.conn.queue_offer(self.queue_name, op["value"])
                return {**op, "type": "ok" if ok else "fail"}
            if op["f"] == "dequeue":
                v = self.conn.queue_poll(self.queue_name)
                if v is None:
                    return {**op, "type": "fail", "error": "empty"}
                return {**op, "type": "ok", "value": v}
            if op["f"] == "drain":
                out = []
                while True:
                    v = self.conn.queue_poll(self.queue_name)
                    if v is None:
                        return {**op, "type": "ok", "value": out}
                    out.append(v)
            return {**op, "type": "fail", "error": f"bad f {op['f']!r}"}
        except DriverError as e:
            return {**op, "type": "info", "error": str(e)[:120]}


class AtomicLongIdClient(_HzClient):
    """IAtomicLong unique-id generation (atomic-long-id-client,
    hazelcast.clj:146-161)."""

    counter_name = "jepsen.atomic-long"

    def invoke(self, test, op):
        assert op["f"] == "generate", op
        try:
            v = self.conn.atomic_long_increment_and_get(self.counter_name)
            return {**op, "type": "ok", "value": v}
        except DriverError as e:
            return {**op, "type": "info", "error": str(e)[:120]}


class MapSetClient(_HzClient):
    """Grow-only set in an IMap under one key via CAS on a sorted long
    array (map-client, hazelcast.clj:453-491). With crdt=True the map
    is the one whose split-brain merges run the shipped
    SetUnionMergePolicy (the <map name="jepsen*"> registration in
    HazelcastDB.setup)."""

    def __init__(self, conn=None, port=None, crdt: bool = True):
        super().__init__(conn, port)
        self.crdt = crdt
        self.map_name = "jepsen.crdt-map" if crdt else "jepsen.map"

    def open(self, test, node):
        return type(self)(self._open(node), port=self.port,
                          crdt=self.crdt)

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                cur = self.conn.map_get(self.map_name, "hi")
                if cur is not None:
                    new = sorted(set(cur) | {op["value"]})
                    ok = self.conn.map_replace_if_same(
                        self.map_name, "hi", cur, new)
                    if ok:
                        return {**op, "type": "ok"}
                    return {**op, "type": "fail", "error": "cas-failed"}
                prev = self.conn.map_put_if_absent(
                    self.map_name, "hi", [op["value"]])
                if prev is None:
                    return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": "cas-failed"}
            if op["f"] == "read":
                cur = self.conn.map_get(self.map_name, "hi")
                return {**op, "type": "ok",
                        "value": sorted(set(cur or []))}
            return {**op, "type": "fail", "error": f"bad f {op['f']!r}"}
        except DriverError as e:
            crash = "fail" if op["f"] == "read" else "info"
            return {**op, "type": crash, "error": str(e)[:120]}


# ---------------------------------------------------------------------------
# workloads (hazelcast.clj:652-777)
# ---------------------------------------------------------------------------

def _lock_workload(lock_name: str, device=None) -> dict:
    return {
        "client": LockClient(lock_name=lock_name),
        "generator": gen.each_thread(gen.stagger(0.1, gen.cycle(
            gen.Seq.of([{"type": "invoke", "f": "acquire"},
                        {"type": "invoke", "f": "release"}])))),
        "checker": jchecker.linearizable(models.mutex(), device=device),
    }


def _map_workload(crdt: bool) -> dict:
    def add(test=None, ctx=None):
        add.i += 1
        return {"type": "invoke", "f": "add", "value": add.i}
    add.i = -1
    return {
        "client": MapSetClient(crdt=crdt),
        "generator": gen.stagger(0.1, add),
        "final_generator": gen.each_thread(
            gen.once({"type": "invoke", "f": "read"})),
        "checker": jchecker.set_checker(),
    }


def workloads(opts: dict | None = None) -> dict:
    opts = opts or {}
    n = opts.get("queue-size", 500)
    return {
        "lock": lambda: _lock_workload("jepsen.lock", opts.get("device")),
        "lock-no-quorum": lambda: _lock_workload("jepsen.lock.no-quorum",
                                                 opts.get("device")),
        "queue": lambda: {
            "client": QueueClient(),
            "generator": queue_wl.generator(n),
            "final_generator": queue_wl.final_generator(),
            "checker": jchecker.total_queue(),
        },
        "atomic-long-ids": lambda: {
            "client": AtomicLongIdClient(),
            "generator": gen.stagger(
                0.5, gen.repeat_gen({"type": "invoke", "f": "generate"})),
            "checker": jchecker.unique_ids(),
        },
        "map": lambda: _map_workload(crdt=False),
        "crdt-map": lambda: _map_workload(crdt=True),
    }


def hazelcast_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "crdt-map")
    return suite_test(
        "hazelcast", wname, opts, workloads(opts),
        db=HazelcastDB(opts.get("version", VERSION)),
        client=opts.get("client"),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: hazelcast_test(
            {**tmap, "workload": resolve_workload(args, tmap, "set")}),
        name="hazelcast",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

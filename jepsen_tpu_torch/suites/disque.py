"""Disque suite.

Counterpart of disque/src/jepsen/disque.clj: source install + cluster
meet, a queue workload over ADDJOB/GETJOB/ACKJOB (dequeue!,
disque.clj:194-231), checked by total-queue. The client speaks RESP
directly (drivers.resp) instead of jedisque.

The port's copy of `jepsen_tpu/suites/disque.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import checker as jchecker
from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis, os_setup
from ..control import util as cutil
from ..drivers import DBError, DriverError
from ..workloads import queue as queue_wl
from . import base_opts, nemesis_cycle
from .sql import resolve

VERSION = "2a2e06c"
DIR = "/opt/disque"
BINARY = f"{DIR}/src/disque-server"
PIDFILE = f"{DIR}/disque.pid"
LOGFILE = f"{DIR}/disque.log"
PORT = 7711
QUEUE = "jepsen"


class DisqueDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """git clone + make + daemonize + CLUSTER MEET fan-in
    (install!/start!/join!, disque.clj:40-106); kill/pause fault
    protocols via SignalProcess."""

    process_pattern = "disque-server"

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, sess, test, node):
        cutil.start_daemon(
            sess, BINARY,
            "--port", str(PORT),
            "--cluster-enabled", "yes",
            "--appendonly", "yes",
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("sh", "-c",
                  f"test -d {DIR} || git clone "
                  f"https://github.com/antirez/disque {DIR}")
        sess.exec("sh", "-c",
                  f"cd {DIR} && git checkout {self.version} && make")
        self._start(sess, test, node)
        nodes = test.get("nodes", [])
        dummy = bool(test.get("ssh", {}).get("dummy"))
        if node == (nodes[0] if nodes else node) and not dummy:
            # cluster-meet goes over the wire protocol, not SSH
            # (join!, disque.clj:95-106) — skipped in dummy mode where
            # no server exists to dial.
            from ..drivers import resp
            import time
            time.sleep(2)
            c = resp.connect(node, PORT)
            for peer in nodes[1:]:
                c.command("CLUSTER", "MEET", peer, PORT)
            c.close()

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", f"{DIR}/appendonly.aof", f"{DIR}/nodes.conf")

    def log_files(self, test, node):
        return [LOGFILE]


class AckIndeterminate(Exception):
    """GETJOB delivered a job but the ACKJOB outcome is unknown."""

    def __init__(self, value):
        super().__init__("ack outcome unknown")
        self.value = value


class DisqueClient(jclient.Client):
    """Queue ops over ADDJOB/GETJOB/ACKJOB (disque.clj:140-231).
    GETJOB with a short timeout; jobs are acked after dequeue, so a
    crash between GET and ACK re-delivers (at-least-once — exactly what
    total-queue tolerates via its :recovered class)."""

    def __init__(self, port: int = PORT, node: str | None = None,
                 timeout: float = 5.0, getjob_timeout_ms: int = 100):
        self.port = port
        self.node = node
        self.timeout = timeout
        self.getjob_timeout_ms = getjob_timeout_ms
        self.conn = None

    def open(self, test, node):
        return DisqueClient(self.port, node, self.timeout,
                            self.getjob_timeout_ms)

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

    def _dequeue1(self):
        """-> value | None (empty). An error on the ACKJOB itself is
        indeterminate — the server may have consumed the job — and
        surfaces as AckIndeterminate so callers report "info", not a
        definite fail (a false "fail" here reads as data loss to
        total-queue)."""
        jobs = self.conn.command(
            "GETJOB", "TIMEOUT", self.getjob_timeout_ms,
            "FROM", QUEUE)
        if not jobs:
            return None
        _q, job_id, body = jobs[0]
        try:
            self.conn.command("ACKJOB", job_id)
        except (DriverError, OSError) as e:
            raise AckIndeterminate(int(body)) from e
        return int(body)

    def _drain(self, test, op):
        """Acked elements survive a mid-drain error (they're gone from
        the server once ACKJOBed): partial drains return ok with what
        was consumed; the other clients' drains pick up the rest."""
        out = []
        try:
            while True:
                v = self._dequeue1()
                if v is None:
                    break
                out.append(v)
        except AckIndeterminate:
            # the unknown element either redelivers (another drain gets
            # it) or was consumed (the reference's failure mode too);
            # the definitively-acked prefix stays in the completion
            self.close(test)
        except (DBError, DriverError, OSError) as e:
            self.close(test)
            if not out:
                return {**op, "type": "fail", "error": str(e)[:160]}
        return {**op, "type": "ok", "value": out}

    def invoke(self, test, op):
        read_only = op["f"] == "dequeue"
        try:
            self._ensure_conn(test)
            if op["f"] == "enqueue":
                self.conn.command(
                    "ADDJOB", QUEUE, str(int(op["value"])), 5000,
                    "RETRY", 1)
                return {**op, "type": "ok"}
            if op["f"] == "dequeue":
                try:
                    v = self._dequeue1()
                except AckIndeterminate:
                    self.close(test)
                    return {**op, "type": "info",
                            "error": "ack-indeterminate"}
                if v is None:
                    return {**op, "type": "fail", "error": "empty"}
                return {**op, "type": "ok", "value": v}
            if op["f"] == "drain":
                return self._drain(test, op)
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except DBError as e:
            return {**op, "type": "fail",
                    "error": f"disque-{e.code}: {e.message[:120]}"}
        except (DriverError, OSError) as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}


def workloads(opts: dict | None = None) -> dict:
    opts = opts or {}
    return {"queue": lambda: queue_wl.test(opts.get("ops", 500))}


def disque_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wl = workloads(opts)["queue"]()
    test = {
        "name": "disque queue",
        "os": os_setup.debian(),
        "db": DisqueDB(opts.get("version", VERSION)),
        "client": opts.get("client") or DisqueClient(),
        "nemesis": jnemesis.partition_random_halves(),
        "checker": jchecker.compose({
            "queue": wl["checker"],
            "perf": jchecker.perf_checker(),
        }),
        # drain AFTER the time limit, with an explicit nemesis stop
        # first — a partition left up at the cutoff would wedge the
        # until-ok drain forever (std-gen, disque.clj:275-296)
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(wl["generator"],
                            nemesis_cycle(
                                opts.get("nemesis-interval", 10)))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            wl["final_generator"]),
        "workload": "queue",
    }
    for k, v in opts.items():
        test.setdefault(k, v)
    return test


def main(argv=None) -> int:
    return jcli.run_cli(lambda tmap, args: disque_test(tmap),
                        name="disque", argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

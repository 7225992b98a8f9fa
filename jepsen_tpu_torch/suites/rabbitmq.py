"""RabbitMQ suite.

Counterpart of rabbitmq/src/jepsen/rabbitmq.clj: apt-installed broker
cluster, a durable queue driven by publish/get/ack (dequeue!,
rabbitmq.clj:104-133), total-queue checking. The client speaks AMQP
0-9-1 directly (drivers.amqp) instead of langohr.

The port's copy of `jepsen_tpu/suites/rabbitmq.py`; it imports the
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
from ..drivers import DBError, DriverError
from ..workloads import queue as queue_wl
from . import base_opts, nemesis_cycle
from .sql import resolve

QUEUE = "jepsen.queue"
LOGFILE = "/var/log/rabbitmq/rabbit.log"


class RabbitDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """apt install + erlang cookie + join_cluster fan-in
    (db, rabbitmq.clj:30-100); kill/pause fault protocols via
    SignalProcess (the beam VM hosts the broker, so signals target
    the rabbitmq process tree)."""

    process_pattern = "rabbitmq"

    def _start(self, sess, test, node):
        sess.exec("service", "rabbitmq-server", "start")

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("apt-get", "install", "-y", "rabbitmq-server")
        # one shared erlang cookie, then every non-primary joins node 0
        sess.exec("service", "rabbitmq-server", "stop")
        sess.exec("sh", "-c",
                  "echo jepsenrabbitcookie > /var/lib/rabbitmq/.erlang.cookie")
        sess.exec("chmod", "400", "/var/lib/rabbitmq/.erlang.cookie")
        sess.exec("chown", "rabbitmq:rabbitmq",
                  "/var/lib/rabbitmq/.erlang.cookie")
        sess.exec("service", "rabbitmq-server", "start")
        nodes = test.get("nodes", [node])
        if node != nodes[0]:
            sess.exec("rabbitmqctl", "stop_app")
            sess.exec("rabbitmqctl", "join_cluster",
                      f"rabbit@{nodes[0]}")
            sess.exec("rabbitmqctl", "start_app")

    def teardown(self, test, node):
        sess = control.current_session().su()
        sess.exec_ok("rabbitmqctl", "stop_app")
        sess.exec_ok("rabbitmqctl", "reset")
        sess.exec_ok("service", "rabbitmq-server", "stop")

    def log_files(self, test, node):
        return [LOGFILE]


class AckIndeterminate(Exception):
    """basic.get delivered a message but the ack outcome is unknown."""

    def __init__(self, value):
        super().__init__("ack outcome unknown")
        self.value = value


class RabbitClient(jclient.Client):
    """Durable-queue ops over AMQP publish/get/ack
    (rabbitmq.clj:135-175). basic.get + explicit ack after the value is
    in hand: a crash between get and ack re-delivers (at-least-once,
    what total-queue's :recovered accounting expects)."""

    def __init__(self, port: int = 5672, node: str | None = None,
                 timeout: float = 5.0):
        self.port = port
        self.node = node
        self.timeout = timeout
        self.conn = None
        self._declared = False

    def open(self, test, node):
        return RabbitClient(self.port, node, self.timeout)

    def _ensure_conn(self, test):
        if self.conn is None:
            from ..drivers import amqp
            host, port = resolve(self.node, self.port, test or {})
            self.conn = amqp.connect(host, port, timeout=self.timeout)
            # publisher confirms: enqueue ok must mean the broker has
            # the message (rabbitmq.clj publishes in confirm mode)
            self.conn.confirm_select()
            self._declared = False
        if not self._declared:
            self.conn.queue_declare(QUEUE, durable=True)
            self._declared = True

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def _dequeue1(self):
        """An error on the ack itself is indeterminate (the broker may
        have consumed the message) — AckIndeterminate makes callers
        report "info" rather than a definite fail."""
        got = self.conn.get(QUEUE)
        if got is None:
            return None
        tag, body = got
        try:
            self.conn.ack(tag)
        except (DriverError, OSError) as e:
            raise AckIndeterminate(int(body)) from e
        return int(body)

    def _drain(self, test, op):
        """Acked elements must survive a mid-drain error: once acked
        they're gone from the broker, so dropping them from the
        completion would read as data loss. Partial drains return ok
        with what was consumed; until_ok's other clients keep draining
        the remainder."""
        out = []
        try:
            while True:
                v = self._dequeue1()
                if v is None:
                    break
                out.append(v)
        except AckIndeterminate:
            self.close(test)   # acked prefix stays; unknown tail either
            # redelivers or counts lost (the reference's mode too)
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
                self.conn.publish(QUEUE, str(int(op["value"])).encode(),
                                  persistent=True)
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
            self.close(test)  # AMQP errors kill the channel
            return {**op, "type": "fail",
                    "error": f"amqp-{e.code}: {e.message[:120]}"}
        except (DriverError, OSError) as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}


def workloads(opts: dict | None = None) -> dict:
    opts = opts or {}
    return {"queue": lambda: queue_wl.test(opts.get("ops", 500))}


def rabbitmq_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wl = workloads(opts)["queue"]()
    test = {
        "name": "rabbitmq queue",
        "os": os_setup.debian(),
        "db": RabbitDB(),
        "client": opts.get("client") or RabbitClient(),
        "nemesis": jnemesis.partition_random_halves(),
        "checker": jchecker.compose({
            "queue": wl["checker"],
            "perf": jchecker.perf_checker(),
        }),
        # drain AFTER the time limit, with an explicit nemesis stop
        # first — a partition left up at the cutoff would wedge the
        # until-ok drain forever (the reference's std-gen shape)
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
    return jcli.run_cli(lambda tmap, args: rabbitmq_test(tmap),
                        name="rabbitmq", argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

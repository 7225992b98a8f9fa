"""Aerospike suite.

Counterpart of aerospike/src/jepsen/aerospike.clj (1,262 LoC, plus the
TLA+ spec at aerospike/spec/aerospike.tla — our model spec lives at
suites/specs/aerospike.tla and makes the lost-acked-write claim the
empirical register workload hunts): deb-installed server with a
mesh-seeded cluster, driven over the bespoke binary message protocol
(drivers/aerospike_msg.py) — CAS registers via generation-check writes
(cas_register.clj:43-90's AerospikeClient usage) and the server-side
INCR counter workload (counter.clj).

The port's copy of `jepsen_tpu/suites/aerospike.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import checker as jchecker
from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import independent
from .. import nemesis as jnemesis, os_setup
from ..drivers import DriverError
from ..drivers import aerospike_msg as asp
from . import base_opts, standard_workloads, suite_test

LOGFILE = "/var/log/aerospike/aerospike.log"


class AerospikeDB(jdb.DB, jdb.LogFiles):
    def __init__(self, version: str = "3.5.4"):
        self.version = version

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://www.aerospike.com/artifacts/aerospike-server-"
               f"community/{self.version}/aerospike-server-community-"
               f"{self.version}-debian7.tgz")
        sess.exec("sh", "-c",
                  f"wget -qO /tmp/aerospike.tgz {url} && "
                  f"tar -xzf /tmp/aerospike.tgz -C /tmp && "
                  f"dpkg -i /tmp/aerospike-server-community-*/"
                  f"aerospike-server-*.deb")
        nodes = test.get("nodes", [node])
        mesh = "\n".join(
            f"    mesh-seed-address-port {n} 3002" for n in nodes)
        cfg = ("service {\n  paxos-single-replica-limit 1\n}\n"
               "network {\n  service { address any\n port 3000 }\n"
               "  heartbeat {\n    mode mesh\n    port 3002\n"
               f"{mesh}\n    interval 150\n    timeout 10\n  }}\n}}\n"
               "namespace jepsen {\n  replication-factor 3\n"
               "  memory-size 1G\n  storage-engine memory\n}\n")
        sess.exec("sh", "-c",
                  f"cat > /etc/aerospike/aerospike.conf "
                  f"<< 'EOF'\n{cfg}\nEOF")
        sess.exec("service", "aerospike", "restart")

    def teardown(self, test, node):
        sess = control.current_session().su()
        sess.exec_ok("service", "aerospike", "stop")

    def log_files(self, test, node):
        return [LOGFILE]


class _AsClient(jclient.Client):
    port = 3000

    def __init__(self, conn: asp.AsConn | None = None,
                 port: int | None = None):
        self.conn = conn
        if port is not None:
            self.port = port

    def open(self, test, node):
        return type(self)(asp.AsConn(node, self.port), port=self.port)

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


class AerospikeCasClient(_AsClient):
    """CAS register: reads return {value, generation}; cas re-reads and
    writes with a generation check, so a concurrent update fails the
    cas (cas_register.clj's record-generation scheme)."""

    def invoke(self, test, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = ((lambda x: independent.tuple_(k, x))
                if independent.is_tuple(v) else (lambda x: x))
        try:
            if op["f"] == "read":
                rec = self.conn.get(k)
                out = None if rec is None else rec["bins"].get("value")
                return {**op, "type": "ok", "value": lift(out)}
            if op["f"] == "write":
                self.conn.put(k, {"value": val})
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = val
                rec = self.conn.get(k)
                if rec is None or rec["bins"].get("value") != old:
                    return {**op, "type": "fail", "error": "precond"}
                try:
                    self.conn.put(k, {"value": new},
                                  generation=rec["generation"])
                except asp.AerospikeError as e:
                    if e.code == asp.RESULT_GENERATION:
                        return {**op, "type": "fail",
                                "error": "generation-mismatch"}
                    raise
                return {**op, "type": "ok"}
            return {**op, "type": "fail", "error": f"bad f {op['f']!r}"}
        except asp.AerospikeError as e:
            return {**op, "type": "fail", "error": str(e)[:120]}
        except DriverError as e:
            crash = "fail" if op["f"] == "read" else "info"
            return {**op, "type": crash, "error": str(e)[:120]}


class AerospikeCounterClient(_AsClient):
    """Server-side INCR counter (counter.clj): add deltas, read the
    running value; checked by the counter-bounds checker."""

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                self.conn.add("counter", "value", op["value"])
                return {**op, "type": "ok"}
            if op["f"] == "read":
                rec = self.conn.get("counter")
                out = 0 if rec is None else rec["bins"].get("value", 0)
                return {**op, "type": "ok", "value": out}
            return {**op, "type": "fail", "error": f"bad f {op['f']!r}"}
        except DriverError as e:
            crash = "fail" if op["f"] == "read" else "info"
            return {**op, "type": crash, "error": str(e)[:120]}
        except asp.AerospikeError as e:
            return {**op, "type": "fail", "error": str(e)[:120]}


def _counter_workload() -> dict:
    import random as _r

    def add(test=None, ctx=None):
        return {"type": "invoke", "f": "add", "value": _r.randint(1, 5)}

    return {
        "client": AerospikeCounterClient(),
        "generator": gen.stagger(1 / 10, gen.mix(
            [add, gen.repeat_gen({"type": "invoke", "f": "read"})])),
        "checker": jchecker.counter(),
    }


def workloads(opts: dict | None = None) -> dict:
    std = standard_workloads(opts)
    return {
        "register": lambda: {**std["register"](),
                             "client": AerospikeCasClient()},
        "counter": _counter_workload,
        "set": std["set"],
        "monotonic": std["monotonic"],
    }


def aerospike_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "register")
    return suite_test(
        "aerospike", wname, opts, workloads(opts),
        db=AerospikeDB(opts.get("version", "3.5.4")),
        client=opts.get("client"),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: aerospike_test(
            {**tmap,
             "workload": resolve_workload(args, tmap, "register")}),
        name="aerospike",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

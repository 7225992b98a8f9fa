"""Apache Ignite suite.

Counterpart of ignite/src/jepsen/ignite/ (549 LoC + the thick-client
Client.java/Bank.java workload): a zip-installed Ignite node per host
with static IP discovery, driven over the thin-client binary protocol
(drivers/ignite_thin.py) — register CAS on a transactional cache and
the bank transfer workload inside PESSIMISTIC/REPEATABLE_READ
transactions, matching Client.java/Bank.java's semantics.

The port's copy of `jepsen_tpu/suites/ignite.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import independent
from .. import nemesis as jnemesis, os_setup
from ..control import util as cutil
from ..drivers import DriverError
from ..drivers import ignite_thin as ig
from ..workloads import bank as bank_wl
from . import base_opts, standard_workloads, suite_test

DIR = "/opt/ignite"
VERSION = "2.7.0"
PIDFILE = f"{DIR}/ignite.pid"
LOGFILE = f"{DIR}/ignite.log"


class IgniteDB(jdb.DB, jdb.LogFiles):
    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("apt-get", "install", "-y", "openjdk-8-jre-headless")
        url = (f"https://archive.apache.org/dist/ignite/{self.version}/"
               f"apache-ignite-{self.version}-bin.zip")
        cutil.install_archive(sess, url, DIR)
        nodes = test.get("nodes", [node])
        addrs = "\n".join(
            f"            <value>{n}:47500</value>" for n in nodes)
        cfg = ("<beans xmlns=\"http://www.springframework.org/schema/"
               "beans\">\n <bean class=\"org.apache.ignite."
               "configuration.IgniteConfiguration\">\n  <property "
               "name=\"discoverySpi\">\n   <bean class=\"org.apache."
               "ignite.spi.discovery.tcp.TcpDiscoverySpi\">\n"
               "    <property name=\"ipFinder\">\n     <bean class="
               "\"org.apache.ignite.spi.discovery.tcp.ipfinder.vm."
               "TcpDiscoveryVmIpFinder\">\n      <property name="
               "\"addresses\">\n       <list>\n"
               f"{addrs}\n       </list>\n      </property>\n     "
               "</bean>\n    </property>\n   </bean>\n  </property>\n"
               " </bean>\n</beans>\n")
        sess.exec("sh", "-c",
                  f"cat > {DIR}/config/jepsen.xml << 'EOF'\n{cfg}\nEOF")
        cutil.start_daemon(
            sess, f"{DIR}/bin/ignite.sh", f"{DIR}/config/jepsen.xml",
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", f"{DIR}/work")

    def log_files(self, test, node):
        return [LOGFILE]


CACHE = "jepsen"


class _IgClient(jclient.Client):
    port = 10800

    def __init__(self, conn: ig.IgniteConn | None = None,
                 port: int | None = None):
        self.conn = conn
        if port is not None:
            self.port = port

    def open(self, test, node):
        conn = ig.IgniteConn(node, self.port)
        try:
            conn.get_or_create_cache(CACHE)
        except ig.IgniteError:
            pass  # already exists / cluster not ready: ops will surface it
        return type(self)(conn, port=self.port)

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


class IgniteRegisterClient(_IgClient):
    """Per-key CAS register over cache ops (Client.java's cache surface:
    get / put / replace(k, old, new))."""

    def invoke(self, test, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = ((lambda x: independent.tuple_(k, x))
                if independent.is_tuple(v) else (lambda x: x))
        try:
            if op["f"] == "read":
                return {**op, "type": "ok",
                        "value": lift(self.conn.get(CACHE, f"r{k}"))}
            if op["f"] == "write":
                self.conn.put(CACHE, f"r{k}", val)
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = val
                if old is None:
                    ok = self.conn.put_if_absent(CACHE, f"r{k}", new)
                else:
                    ok = self.conn.replace_if_equals(
                        CACHE, f"r{k}", old, new)
                return {**op, "type": "ok" if ok else "fail",
                        **({} if ok else {"error": "cas-failed"})}
            return {**op, "type": "fail", "error": f"bad f {op['f']!r}"}
        except DriverError as e:
            crash = "fail" if op["f"] == "read" else "info"
            return {**op, "type": crash, "error": str(e)[:120]}


class IgniteBankClient(_IgClient):
    """Transfers inside thin-client transactions (Bank.java runs
    PESSIMISTIC / REPEATABLE_READ around read-modify-write pairs)."""

    accounts = tuple(bank_wl.DEFAULT_ACCOUNTS)
    total = bank_wl.DEFAULT_TOTAL

    def open(self, test, node):
        c = super().open(test, node)
        per = self.total // len(self.accounts)
        rem = self.total - per * len(self.accounts)
        try:
            for a in self.accounts:
                c.conn.put_if_absent(CACHE, f"acct{a}",
                                     per + (rem if a == 0 else 0))
        except DriverError:
            pass
        return c

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                tx = self.conn.tx_start()
                try:
                    out = {a: self.conn.get(CACHE, f"acct{a}", tx=tx)
                           for a in self.accounts}
                    self.conn.tx_end(tx, True)
                except BaseException:
                    self.conn.tx_end(tx, False)
                    raise
                return {**op, "type": "ok", "value": out}
            if op["f"] == "transfer":
                v = op["value"]
                frm, to, amt = v["from"], v["to"], v["amount"]
                tx = self.conn.tx_start()
                try:
                    b1 = self.conn.get(CACHE, f"acct{frm}", tx=tx)
                    b2 = self.conn.get(CACHE, f"acct{to}", tx=tx)
                    if b1 is None or b1 < amt:
                        self.conn.tx_end(tx, False)
                        return {**op, "type": "fail",
                                "error": "insufficient"}
                    self.conn.put(CACHE, f"acct{frm}", b1 - amt, tx=tx)
                    self.conn.put(CACHE, f"acct{to}", (b2 or 0) + amt,
                                  tx=tx)
                    self.conn.tx_end(tx, True)
                except BaseException:
                    try:
                        self.conn.tx_end(tx, False)
                    except DriverError:
                        pass
                    raise
                return {**op, "type": "ok"}
            return {**op, "type": "fail", "error": f"bad f {op['f']!r}"}
        except ig.IgniteError as e:
            return {**op, "type": "fail", "error": str(e)[:120]}
        except DriverError as e:
            crash = "fail" if op["f"] == "read" else "info"
            return {**op, "type": crash, "error": str(e)[:120]}


def workloads(opts: dict | None = None) -> dict:
    std = standard_workloads(opts)
    return {
        "bank": lambda: {**std["bank"](), "client": IgniteBankClient()},
        "register": lambda: {**std["register"](),
                             "client": IgniteRegisterClient()},
        "set": std["set"],
    }


def ignite_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "bank")
    return suite_test(
        "ignite", wname, opts, workloads(opts),
        db=IgniteDB(opts.get("version", VERSION)),
        client=opts.get("client"),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: ignite_test(
            {**tmap, "workload": resolve_workload(args, tmap, "bank")}),
        name="ignite",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

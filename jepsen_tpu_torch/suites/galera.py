"""Galera (MariaDB + wsrep) suite.

Counterpart of galera/src/jepsen/galera.clj: apt-installed MariaDB
with a wsrep cluster address (configure!, galera.clj:64-74), driven
over the mysql protocol. Workload matrix mirrors the reference's sets
+ bank tests plus the shared SQL extras.

The port's copy of `jepsen_tpu/suites/galera.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import cli as jcli
from .. import control
from .. import db as jdb
from .. import nemesis as jnemesis, os_setup
from ..workloads import dirty_reads
from . import base_opts, sql, standard_workloads, suite_test

LOGFILE = "/var/log/mysql/error.log"


class GaleraDB(jdb.DB, jdb.LogFiles):
    """apt install mariadb-galera + wsrep cluster bootstrap
    (install!/configure!/setup-db!, galera.clj:34-100)."""

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("apt-get", "install", "-y", "mariadb-server", "galera-4")
        nodes = test.get("nodes", [node])
        cluster = ",".join(nodes)
        cfg = "\n".join([
            "[galera]",
            "wsrep_on=ON",
            "wsrep_provider=/usr/lib/galera/libgalera_smm.so",
            f"wsrep_cluster_address=gcomm://{cluster}",
            f"wsrep_node_address={node}",
            f"wsrep_node_name={node}",
            "binlog_format=row",
            "default_storage_engine=InnoDB",
            "innodb_autoinc_lock_mode=2",
            "bind-address=0.0.0.0",
        ])
        sess.exec("sh", "-c",
                  f"cat > /etc/mysql/conf.d/galera.cnf << 'EOF'\n{cfg}\nEOF")
        if node == nodes[0]:
            sess.exec("galera_new_cluster")
        else:
            sess.exec("service", "mysql", "restart")

    def teardown(self, test, node):
        sess = control.current_session().su()
        sess.exec_ok("service", "mysql", "stop")

    def log_files(self, test, node):
        return [LOGFILE]


def workloads(opts: dict | None = None) -> dict:
    std = standard_workloads(opts)
    # galera.clj ships sets + bank; register/monotonic ride along from
    # the shared matrix. dirty-reads is the suite's signature check
    # (galera/src/jepsen/galera/dirty_reads.clj:1-120).
    out = {k: std[k] for k in ("set", "bank", "register", "monotonic")}
    out["dirty-reads"] = dirty_reads.workload
    return out


def default_client(workload: str, opts: dict):
    sql_opts = opts.get("sql-opts")
    if workload == "dirty-reads":
        # A healthy cluster rarely aborts on its own; deliberate
        # rollbacks keep the checker's failed-write pool non-empty.
        # Merge per-key so unrelated sql-opts don't void the default.
        sql_opts = {"abort_prob": 0.05, **(sql_opts or {})}
    return sql.client_for(
        sql.MySQLDialect(port=3306, user="root", database="test"),
        workload, {**opts, "sql-opts": sql_opts})


def galera_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "bank")
    return suite_test(
        "galera", wname, opts, workloads(opts),
        db=GaleraDB(),
        client=opts.get("client") or default_client(wname, opts),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: galera_test(
            {**tmap, "workload": resolve_workload(args, tmap, "bank")}),
        name="galera",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

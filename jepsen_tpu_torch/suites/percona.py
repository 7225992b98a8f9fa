"""Percona XtraDB Cluster suite.

Counterpart of percona/src/jepsen/percona.clj (bank + sets over a
galera-based XtraDB cluster, mysql protocol). Same shape as the galera
suite with Percona's packages and bootstrap command.

The port's copy of `jepsen_tpu/suites/percona.py`; it imports the
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


class PerconaDB(jdb.DB, jdb.LogFiles):
    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("apt-get", "install", "-y", "percona-xtradb-cluster-57")
        nodes = test.get("nodes", [node])
        cluster = ",".join(nodes)
        cfg = "\n".join([
            "[mysqld]",
            "wsrep_provider=/usr/lib/galera3/libgalera_smm.so",
            f"wsrep_cluster_address=gcomm://{cluster}",
            f"wsrep_node_address={node}",
            "wsrep_sst_method=xtrabackup-v2",
            "pxc_strict_mode=ENFORCING",
            "binlog_format=ROW",
            "default_storage_engine=InnoDB",
            "innodb_autoinc_lock_mode=2",
        ])
        sess.exec("sh", "-c",
                  f"cat > /etc/mysql/percona-xtradb-cluster.conf.d/"
                  f"jepsen.cnf << 'EOF'\n{cfg}\nEOF")
        if node == nodes[0]:
            sess.exec("sh", "-c",
                      "systemctl start mysql@bootstrap || "
                      "/etc/init.d/mysql bootstrap-pxc")
        else:
            sess.exec("service", "mysql", "restart")

    def teardown(self, test, node):
        sess = control.current_session().su()
        sess.exec_ok("service", "mysql", "stop")

    def log_files(self, test, node):
        return [LOGFILE]


def workloads(opts: dict | None = None) -> dict:
    std = standard_workloads(opts)
    # dirty-reads is the suite's signature check
    # (percona/src/jepsen/percona/dirty_reads.clj:1-120).
    out = {k: std[k] for k in ("set", "bank", "register", "sequential")}
    out["dirty-reads"] = dirty_reads.workload
    return out


def default_client(workload: str, opts: dict):
    sql_opts = opts.get("sql-opts")
    if workload == "dirty-reads":
        # merge per-key so unrelated sql-opts don't void the default
        sql_opts = {"abort_prob": 0.05, **(sql_opts or {})}
    return sql.client_for(
        sql.MySQLDialect(port=3306, user="root", database="test"),
        workload, {**opts, "sql-opts": sql_opts})


def percona_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "bank")
    return suite_test(
        "percona", wname, opts, workloads(opts),
        db=PerconaDB(),
        client=opts.get("client") or default_client(wname, opts),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: percona_test(
            {**tmap, "workload": resolve_workload(args, tmap, "bank")}),
        name="percona",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

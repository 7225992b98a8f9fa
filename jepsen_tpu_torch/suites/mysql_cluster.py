"""MySQL Cluster (NDB) suite.

Counterpart of mysql-cluster/src/jepsen/mysql_cluster.clj (227 LoC):
management daemon on node 0, ndbd data nodes, mysqld SQL nodes, bank
workload over the mysql protocol.

The port's copy of `jepsen_tpu/suites/mysql_cluster.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import cli as jcli
from .. import control
from .. import db as jdb
from .. import nemesis as jnemesis, os_setup
from ..control import util as cutil
from . import base_opts, sql, standard_workloads, suite_test

DIR = "/opt/mysql-cluster"
VERSION = "7.4.8"


class MySQLClusterDB(jdb.DB, jdb.LogFiles):
    """ndb_mgmd (node 0) + ndbd + mysqld on each node."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://dev.mysql.com/get/Downloads/MySQL-Cluster-7.4/"
               f"mysql-cluster-gpl-{self.version}-linux-glibc2.5-"
               f"x86_64.tar.gz")
        cutil.install_archive(sess, url, DIR)
        nodes = test.get("nodes", [node])
        mgmd = nodes[0]
        if node == mgmd:
            ndbds = "\n".join(f"[ndbd]\nhostname={n}" for n in nodes)
            mysqlds = "\n".join(f"[mysqld]\nhostname={n}" for n in nodes)
            cfg = (f"[ndb_mgmd]\nhostname={mgmd}\ndatadir={DIR}/mgm\n"
                   f"[ndbd default]\nnoofreplicas=2\n"
                   f"datadir={DIR}/data\n{ndbds}\n{mysqlds}\n")
            sess.exec("mkdir", "-p", f"{DIR}/mgm")
            sess.exec("sh", "-c",
                      f"cat > {DIR}/config.ini << 'EOF'\n{cfg}\nEOF")
            cutil.start_daemon(
                sess, f"{DIR}/bin/ndb_mgmd", "--initial",
                "-f", f"{DIR}/config.ini",
                "--configdir", DIR,
                logfile=f"{DIR}/mgmd.log", pidfile=f"{DIR}/mgmd.pid",
                chdir=DIR)
        sess.exec("mkdir", "-p", f"{DIR}/data")
        cutil.start_daemon(
            sess, f"{DIR}/bin/ndbd",
            "--ndb-connectstring", mgmd,
            logfile=f"{DIR}/ndbd.log", pidfile=f"{DIR}/ndbd.pid",
            chdir=DIR)
        cutil.start_daemon(
            sess, f"{DIR}/bin/mysqld",
            "--ndbcluster",
            f"--ndb-connectstring={mgmd}",
            "--user=root",
            logfile=f"{DIR}/mysqld.log", pidfile=f"{DIR}/mysqld.pid",
            chdir=DIR)

    def teardown(self, test, node):
        sess = control.current_session().su()
        for pid in ("mysqld.pid", "ndbd.pid", "mgmd.pid"):
            cutil.stop_daemon(sess, f"{DIR}/{pid}")
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [f"{DIR}/mgmd.log", f"{DIR}/ndbd.log", f"{DIR}/mysqld.log"]


def workloads(opts: dict | None = None) -> dict:
    std = standard_workloads(opts)
    return {k: std[k] for k in ("bank", "set", "register")}


def default_client(workload: str, opts: dict):
    return sql.client_for(
        sql.MySQLDialect(port=3306, user="root", database="test"),
        workload, opts)


def mysql_cluster_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "bank")
    return suite_test(
        "mysql-cluster", wname, opts, workloads(opts),
        db=MySQLClusterDB(opts.get("version", VERSION)),
        client=opts.get("client") or default_client(wname, opts),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: mysql_cluster_test(
            {**tmap, "workload": resolve_workload(args, tmap, "bank")}),
        name="mysql-cluster",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

"""YugabyteDB suite — config #5's serializability sweep.

Counterpart of yugabyte/src/yugabyte (dual-API workload matrix,
yugabyte/core.clj:74-110; SURVEY.md §2.6): master + tserver daemons and
a matrix of counter-ish (monotonic), set, bank, long-fork, append, wr,
register workloads, optionally swept across both APIs the way the
reference sweeps YCQL/YSQL (the `api` opt tags the test; client adapters
are pluggable per API).

The port's copy of `jepsen_tpu/suites/yugabyte.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import cli as jcli
from .. import control
from .. import db as jdb
from .. import nemesis as jnemesis, os_setup
from ..control import util as cutil
from . import base_opts, sql, standard_workloads, suite_test

VERSION = "1.3.1.0"
DIR = "/opt/yugabyte"

APIS = ("ysql", "ycql")


class YugaByteDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """yb-master + yb-tserver daemons (yugabyte/src/yugabyte/db.clj);
    whole-node kill/pause via SignalProcess."""

    process_pattern = f"{DIR}/bin"

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://downloads.yugabyte.com/"
               f"yugabyte-ce-{self.version}-linux.tar.gz")
        cutil.install_archive(sess, url, DIR)
        self._start(sess, test, node)

    def _start(self, sess, test, node):
        masters = ",".join(f"{n}:7100" for n in test.get("nodes", [])[:3])
        if node in test.get("nodes", [])[:3]:
            cutil.start_daemon(
                sess, f"{DIR}/bin/yb-master",
                "--master_addresses", masters,
                "--rpc_bind_addresses", f"{node}:7100",
                "--fs_data_dirs", f"{DIR}/data/master",
                logfile=f"{DIR}/master.log", pidfile=f"{DIR}/master.pid",
                chdir=DIR)
        cutil.start_daemon(
            sess, f"{DIR}/bin/yb-tserver",
            "--tserver_master_addrs", masters,
            "--rpc_bind_addresses", f"{node}:9100",
            "--fs_data_dirs", f"{DIR}/data/tserver",
            logfile=f"{DIR}/tserver.log", pidfile=f"{DIR}/tserver.pid",
            chdir=DIR)

    def teardown(self, test, node):
        sess = control.current_session().su()
        for pid in ("tserver.pid", "master.pid"):
            cutil.stop_daemon(sess, f"{DIR}/{pid}")
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [f"{DIR}/master.log", f"{DIR}/tserver.log"]


def workloads(opts: dict | None = None, api: str = "ysql") -> dict:
    """The per-API workload matrix (yugabyte/core.clj:74-110): YSQL
    runs the full set; YCQL mirrors the reference's ycql/ namespace
    (bank, counter≈monotonic, long-fork, set, single-key-acid≈register)
    — append/wr need read-write txns YCQL blocks can't express."""
    std = standard_workloads(opts)
    names = ("register", "set", "bank", "long-fork", "append", "wr",
             "monotonic")
    if api == "ycql":
        names = ("register", "set", "bank", "long-fork", "monotonic")
    out = {k: std[k] for k in names}
    if api == "ycql":
        # YCQL transfers are blind server-side +/- in a txn block
        # (ycql/bank.clj:46-58): overdrafts are expected, only the
        # total is conserved.
        from ..workloads import bank as bank_wl

        def _pkg(t):
            return {"generator": t["generator"], "checker": t["checker"]}

        out["bank"] = lambda: _pkg(bank_wl.test(negative_balances=True))
    return out


#: nemesis-name -> constructor (run-jepsen.py's NEMESES sweep names;
#: the process-level ones target yb-tserver like the reference's)
NEMESES = {
    "none": jnemesis.noop,
    "partition": jnemesis.partition_random_halves,
    "partition-half": jnemesis.partition_halves,
    "partition-one": jnemesis.partition_random_node,
    "partition-ring": jnemesis.partition_majorities_ring,
    "pause-tserver": lambda: jnemesis.hammer_time("yb-tserver"),
    "pause-master": lambda: jnemesis.hammer_time("yb-master"),
}


def default_client(api: str, workload: str, opts: dict):
    """YSQL speaks pg-wire on 5433 (yugabyte/src/yugabyte/ysql).
    YCQL speaks the CQL binary protocol on 9042 (yugabyte/ycql)."""
    if api == "ycql":
        from . import ycql
        return ycql.client_for(workload, opts)
    return sql.client_for(
        sql.PGDialect(port=5433, user="yugabyte", database="yugabyte"),
        workload, opts)


def yugabyte_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    api = opts.get("api", "ysql")
    wname = opts.get("workload", "bank")
    nemesis_name = opts.get("nemesis", "partition")
    if nemesis_name not in NEMESES:
        raise ValueError(f"unknown nemesis {nemesis_name!r}; "
                         f"have {sorted(NEMESES)}")
    test = suite_test(
        f"yugabyte-{api}", wname, opts,
        workloads(opts, api),
        db=YugaByteDB(opts.get("version", VERSION)),
        client=opts.get("client") or default_client(api, wname, opts),
        nemesis=NEMESES[nemesis_name](),
        os_setup=os_setup.debian())
    test["api"] = api
    test["nemesis-name"] = nemesis_name
    return test


def all_tests(opts: dict | None = None) -> list[dict]:
    """The full api × workload sweep (yugabyte/core.clj:74-110,
    run-jepsen.py's sweep)."""
    opts = base_opts(**(opts or {}))
    return [yugabyte_test({**opts, "api": api, "workload": w})
            for api in APIS for w in sorted(workloads(opts, api))]


def main(argv=None) -> int:
    from . import resolve_workload

    def opt_fn(p):
        p.add_argument("--workload", default=None,
                       choices=sorted(workloads()))
        p.add_argument("--api", default=None, choices=APIS)
        p.add_argument("--nemesis", default="partition",
                       choices=sorted(NEMESES))

    return jcli.run_cli(
        lambda tmap, args: yugabyte_test(
            {**tmap, "workload": resolve_workload(args, tmap, "bank"),
             "api": (getattr(args, "api", None) or tmap.get("api")
                     or "ysql"),
             "nemesis": getattr(args, "nemesis", "partition")}),
        name="yugabyte", opt_fn=opt_fn,
        tests_fn=lambda tmap, args: [
            yugabyte_test({**tmap, "api": api, "workload": w,
                           "nemesis": getattr(args, "nemesis",
                                              "partition")})
            for api in ([args.api] if getattr(args, "api", None)
                        else APIS)
            for w in ([args.workload] if getattr(args, "workload", None)
                      else sorted(workloads(tmap, api)))],
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

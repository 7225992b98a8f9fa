"""CockroachDB suite — config #3 of the north star.

Counterpart of cockroachdb/src/jepsen/cockroach.clj and its workloads
(register, bank, monotonic, sequential, sets, comments/g2; SURVEY.md
§2.6): a single-binary tarball install with a multi-node --join cluster,
and a workload matrix built from the shared library. SQL access is
driver-pluggable: pass ``connect_fn`` (a psycopg2-compatible connect)
into the client; the workload/checker layer is complete without it (the
analyze path for stored histories needs no driver at all).

The port's copy of `jepsen_tpu/suites/cockroach.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import checker as jchecker
from .. import cli as jcli
from .. import control
from .. import db as jdb
from .. import nemesis as jnemesis, os_setup
from ..nemesis import clock as jclock
from ..control import util as cutil
from . import base_opts, sql, standard_workloads, suite_test

VERSION = "v19.1.5"
DIR = "/opt/cockroach"
BINARY = f"{DIR}/cockroach"
LOGFILE = f"{DIR}/cockroach.log"
PIDFILE = f"{DIR}/cockroach.pid"


class CockroachDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """Tarball install + `cockroach start --join` cluster
    (cockroachdb/src/jepsen/cockroach.clj's db); kill/pause fault
    protocols via SignalProcess."""

    process_pattern = "cockroach"

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, sess, test, node):
        join = ",".join(f"{n}:26257" for n in test.get("nodes", []))
        cutil.start_daemon(
            sess, BINARY, "start", "--insecure",
            "--store", f"{DIR}/data",
            "--listen-addr", f"{node}:26257",
            "--http-addr", f"{node}:8080",
            "--join", join,
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://binaries.cockroachdb.com/"
               f"cockroach-{self.version}.linux-amd64.tgz")
        cutil.install_archive(sess, url, DIR)
        self._start(sess, test, node)
        if node == (test.get("nodes") or [node])[0]:
            # The daemon launch returns before the server listens; retry
            # init until it connects. "already been initialized" (from a
            # prior cycle) also counts as success.
            import time
            last = None
            for _ in range(30):
                res = sess.exec_ok(BINARY, "init", "--insecure",
                                   "--host", f"{node}:26257")
                if res.exit == 0 or "already been initialized" in res.err:
                    break
                last = res
                time.sleep(1)
            else:
                raise control.CommandError(
                    "cockroach init", last.exit if last else -1,
                    last.out if last else "", last.err if last else "",
                    node)

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [LOGFILE]


def workloads(opts: dict | None = None) -> dict:
    from ..workloads import comments as comments_wl
    std = standard_workloads(opts)
    # cockroach's matrix: register, bank, monotonic, sequential, sets,
    # g2 from the shared library, plus the suite's signature comments
    # strict-serializability check (cockroach/comments.clj:1-160).
    out = {k: std[k] for k in
           ("register", "bank", "monotonic", "sequential", "set", "g2")}
    out["comments"] = lambda: comments_wl.workload(opts)
    return out


def default_client(workload: str, opts: dict):
    """pg-wire client on cockroach's SQL port (the reference drives
    cockroach through jdbc/postgres, cockroach/client.clj:1-60)."""
    return sql.client_for(
        sql.PGDialect(port=26257, user="root", database="defaultdb"),
        workload, opts)


#: The reference cockroach suite's nemesis menu
#: (cockroachdb/src/jepsen/cockroach/nemesis.clj): partitions, clock
#: skew via the on-node bump/strobe helpers, and process pauses.
NEMESES = {
    "none": jnemesis.noop,
    "partition": jnemesis.partition_random_halves,
    "partition-half": jnemesis.partition_halves,
    "partition-ring": jnemesis.partition_majorities_ring,
    "clock": jclock.clock_nemesis,
    "pause": lambda: jnemesis.hammer_time("cockroach"),
}


def cockroach_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "register")
    nemesis_name = opts.get("nemesis", "partition")
    if nemesis_name not in NEMESES:
        raise ValueError(f"unknown nemesis {nemesis_name!r}; "
                         f"have {sorted(NEMESES)}")
    test = suite_test(
        "cockroach", wname, opts,
        workloads(opts),
        db=CockroachDB(opts.get("version", VERSION)),
        client=opts.get("client") or default_client(wname, opts),
        nemesis=NEMESES[nemesis_name](),
        os_setup=os_setup.debian())
    test["nemesis-name"] = nemesis_name
    return test


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: cockroach_test(
            {**tmap,
             "workload": resolve_workload(args, tmap, "register"),
             "nemesis": getattr(args, "nemesis", "partition")}),
        name="cockroach",
        opt_fn=lambda p: (
            p.add_argument("--workload", default=None,
                           choices=sorted(workloads())),
            p.add_argument("--nemesis", default="partition",
                           choices=sorted(NEMESES))),
        tests_fn=lambda tmap, args: [
            cockroach_test({**tmap, "workload": w,
                            "nemesis": getattr(args, "nemesis",
                                               "partition")})
            for w in ([args.workload] if getattr(
                args, "workload", None) else sorted(workloads()))],
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

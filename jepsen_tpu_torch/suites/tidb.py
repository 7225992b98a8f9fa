"""TiDB suite — config #4 of the north star.

Counterpart of tidb/src/tidb (workload registry with option sweeps,
tidb/core.clj:32-100; SURVEY.md §2.6): the pd / tikv / tidb daemon trio
installed from the release tarball, and a workload matrix of bank,
long-fork, append/wr (Elle), register, set, sequential, monotonic.
SQL access is driver-pluggable as in the cockroach suite.

The port's copy of `jepsen_tpu/suites/tidb.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import random

from .. import checker as jchecker
from .. import cli as jcli
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis, os_setup
from ..control import util as cutil
from . import base_opts, sql, standard_workloads, suite_test

VERSION = "v3.0.3"
DIR = "/opt/tidb"
LOGDIR = f"{DIR}/logs"

class TiDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """pd + tikv + tidb daemons (tidb/src/tidb/db.clj's install);
    whole-node kill/pause across all three via SignalProcess (the
    pattern matches every binary under the install dir)."""

    process_pattern = f"{DIR}/bin"

    def __init__(self, version: str = VERSION):
        self.version = version

    def _pd_cluster(self, test) -> str:
        return ",".join(f"{n}=http://{n}:2380"
                        for n in test.get("nodes", []))

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://download.pingcap.org/"
               f"tidb-{self.version}-linux-amd64.tar.gz")
        cutil.install_archive(sess, url, DIR)
        sess.exec("mkdir", "-p", LOGDIR)
        self._start(sess, test, node)

    def _start(self, sess, test, node):
        cutil.start_daemon(
            sess, f"{DIR}/bin/pd-server",
            "--name", node,
            "--client-urls", f"http://{node}:2379",
            "--peer-urls", f"http://{node}:2380",
            "--initial-cluster", self._pd_cluster(test),
            logfile=f"{LOGDIR}/pd.log", pidfile=f"{DIR}/pd.pid", chdir=DIR)
        pds = ",".join(f"{n}:2379" for n in test.get("nodes", []))
        cutil.start_daemon(
            sess, f"{DIR}/bin/tikv-server",
            "--pd", pds,
            "--addr", f"{node}:20160",
            "--data-dir", f"{DIR}/tikv",
            logfile=f"{LOGDIR}/tikv.log", pidfile=f"{DIR}/tikv.pid",
            chdir=DIR)
        cutil.start_daemon(
            sess, f"{DIR}/bin/tidb-server",
            "--store", "tikv",
            "--path", pds,
            "--host", node,
            logfile=f"{LOGDIR}/tidb.log", pidfile=f"{DIR}/tidb.pid",
            chdir=DIR)

    def teardown(self, test, node):
        sess = control.current_session().su()
        for pid in ("tidb.pid", "tikv.pid", "pd.pid"):
            cutil.stop_daemon(sess, f"{DIR}/{pid}")
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [f"{LOGDIR}/pd.log", f"{LOGDIR}/tikv.log",
                f"{LOGDIR}/tidb.log"]


class TableChecker(jchecker.Checker):
    """tidb/table.clj:69-77: an insert that bounced off a 'missing'
    table is the anomaly — the generator only ever inserts into tables
    whose creation was already acknowledged."""

    def check(self, test, history, opts):
        bad = [op for op in history
               if op.get("type") == "fail"
               and op.get("error") == "doesnt-exist"]
        return {"valid?": not bad, "errors": bad[:16],
                "error-count": len(bad)}


def table_workload(opts: dict | None = None) -> dict:
    """tidb/table.clj:54-67,79-85: repeatedly create fresh tables;
    80% of the time insert into the last table whose create-table op
    completed ok. DDL that isn't visible to subsequent inserts shows
    up as `doesnt-exist` failures."""
    state = {"last": None, "next": 0}

    def emit(test=None, ctx=None):
        if state["last"] is not None and random.random() < 0.8:
            return {"type": "invoke", "f": "insert",
                    "value": [state["last"], 0]}
        state["next"] += 1
        return {"type": "invoke", "f": "create-table",
                "value": state["next"]}

    def watch(this, test, ctx, event):
        # the reference bumps last-created-table as each create COMMITS
        # (table.clj:28-32's swap! in invoke!)
        if (event.get("type") == "ok"
                and event.get("f") == "create-table"):
            v = int(event["value"])
            state["last"] = v if state["last"] is None \
                else max(state["last"], v)
        return this

    return {"generator": gen.on_update(watch, emit),
            "checker": jchecker.compose({"table": TableChecker()})}


def workloads(opts: dict | None = None) -> dict:
    std = standard_workloads(opts)
    out = {k: std[k] for k in
           ("bank", "long-fork", "append", "wr", "register", "set",
            "sequential", "monotonic")}
    out["table"] = lambda: table_workload(opts)
    return out


#: Per-workload option sweeps (tidb/core.clj:47-79 workload-options):
#: each option maps to every value the sweep should try.
WORKLOAD_OPTIONS: dict[str, dict[str, list]] = {
    "append":     {"auto-retry": [True, False],
                   "auto-retry-limit": [10, 0],
                   "read-lock": [None, "FOR UPDATE"]},
    "bank":       {"auto-retry": [True, False],
                   "auto-retry-limit": [10, 0],
                   "update-in-place": [True, False],
                   "read-lock": [None, "FOR UPDATE"]},
    "long-fork":  {"auto-retry": [True, False],
                   "auto-retry-limit": [10, 0]},
    "monotonic":  {"auto-retry": [True, False],
                   "auto-retry-limit": [10, 0]},
    "register":   {"auto-retry": [True, False],
                   "auto-retry-limit": [10, 0],
                   "read-lock": [None, "FOR UPDATE"]},
    "wr":         {"auto-retry": [True, False],
                   "auto-retry-limit": [10, 0],
                   "read-lock": [None, "FOR UPDATE"]},
    "set":        {"auto-retry": [True, False],
                   "auto-retry-limit": [10, 0]},
    "sequential": {"auto-retry": [True, False],
                   "auto-retry-limit": [10, 0]},
    "table":      {},   # table.clj has no option knobs
}


def expected_to_pass_options() -> dict:
    """Sweep restricted to combos expected valid: auto-retry off
    (tidb/core.clj:81-86 workload-options-expected-to-pass)."""
    return {w: {**o, "auto-retry": [False], "auto-retry-limit": [0]}
            for w, o in WORKLOAD_OPTIONS.items()}


def quick_options() -> dict:
    """One representative combo per workload: defaults only, no read
    locks (tidb/core.clj:88-105 quick-workload-options). update-in-place
    stays True — the safe server-side-arithmetic default; False is the
    deliberately lost-update-prone sweep variant."""
    return {w: {k: [None] if k == "read-lock"
                else [True] if k == "update-in-place"
                else [v[0]]
                for k, v in o.items()}
            for w, o in WORKLOAD_OPTIONS.items()}


def option_combos(options: dict[str, list]) -> list[dict]:
    """Cartesian product of one workload's option values."""
    import itertools
    keys = sorted(options)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(options[k] for k in keys))]


def _session_stmts(combo: dict) -> list[str]:
    """The tidb session knobs an option combo sets on every connection
    (tidb/sql.clj's set-session-variables)."""
    stmts = []
    if "auto-retry" in combo:
        on = bool(combo["auto-retry"])
        stmts.append(f"SET @@tidb_disable_txn_auto_retry = "
                     f"{0 if on else 1}")
    if combo.get("auto-retry-limit") is not None:
        stmts.append(f"SET @@tidb_retry_limit = "
                     f"{int(combo['auto-retry-limit'])}")
    return stmts


def default_client(workload: str, opts: dict):
    """mysql-protocol client on tidb-server's port (the reference
    drives tidb through jdbc/mysql, tidb/src/tidb/sql.clj). Workload
    options become session variables + client knobs."""
    combo = opts.get("workload-options") or {}
    dialect = sql.MySQLDialect(port=4000, user="root", database="test",
                               session_stmts=_session_stmts(combo))
    sql_opts = {"read_lock": combo.get("read-lock"),
                "update_in_place": combo.get("update-in-place", True)}
    return sql.client_for(dialect, workload,
                          {**opts, "sql-opts": sql_opts})


def tidb_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "append")
    test = suite_test(
        "tidb", wname, opts, workloads(opts),
        db=TiDB(opts.get("version", VERSION)),
        client=opts.get("client") or default_client(wname, opts),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())
    combo = opts.get("workload-options")
    if combo:
        flavor = " ".join(f"{k}={v}" for k, v in sorted(combo.items()))
        test["name"] = f"tidb {wname} {flavor}"
        test["workload-options"] = combo
    return test


def all_tests(opts: dict | None = None, tier: str = "full") -> list[dict]:
    """The workload x option sweep (tidb/core.clj's test-all): tier
    "full" | "expected" | "quick" picks the option matrix."""
    opts = dict(opts or {})
    matrix = {"full": WORKLOAD_OPTIONS,
              "expected": expected_to_pass_options(),
              "quick": quick_options()}[tier]
    wanted = ([opts["workload"]] if opts.get("workload")
              else sorted(workloads()))
    return [tidb_test({**opts, "workload": w, "workload-options": combo})
            for w in wanted
            for combo in option_combos(matrix.get(w, {}))]


def main(argv=None) -> int:
    from . import resolve_workload

    def opt_fn(p):
        p.add_argument("--workload", default=None,
                       choices=sorted(workloads()))
        p.add_argument("--sweep", default="quick",
                       choices=("full", "expected", "quick"),
                       help="option-matrix tier for test-all")

    return jcli.run_cli(
        lambda tmap, args: tidb_test(
            {**tmap, "workload": resolve_workload(args, tmap, "append")}),
        name="tidb",
        opt_fn=opt_fn,
        tests_fn=lambda tmap, args: all_tests(
            {**tmap, "workload": getattr(args, "workload", None)},
            tier=getattr(args, "sweep", "quick")),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

"""CrateDB suite.

Counterpart of crate/src/jepsen/crate/ (core + dirty_read +
lost_updates + version_divergence, 1,060 LoC): a tarball-installed
Crate cluster driven over its PostgreSQL wire port (5432 — the same
pg-wire driver the cockroach suite uses; the reference goes through
Crate's JDBC). dirty-read maps onto the shared register matrix;
version-divergence and lost-updates are implemented natively below
(version_divergence.clj:29-140, lost_updates.clj:32-148): both pivot
on Crate's `_version` system column — one value per row version, and
optimistic concurrency via `WHERE ... AND _version = ?`.

The port's copy of `jepsen_tpu/suites/crate.py`; it imports the
standard library and the port's own modules only. Its register and wr
checkers are `standard_workloads`', which run on `opts["device"]`.
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
from ..control import util as cutil
from . import base_opts, sql, standard_workloads, suite_test

VERSION = "0.57.4"
DIR = "/opt/crate"
PIDFILE = f"{DIR}/crate.pid"
LOGFILE = f"{DIR}/logs/crate.log"


class CrateDB(jdb.DB, jdb.LogFiles):
    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://cdn.crate.io/downloads/releases/"
               f"crate-{self.version}.tar.gz")
        cutil.install_archive(sess, url, DIR)
        nodes = test.get("nodes", [node])
        hosts = ",".join(f"{n}:4300" for n in nodes)
        cutil.start_daemon(
            sess, f"{DIR}/bin/crate",
            f"-Cnode.name={node}",
            f"-Cnetwork.host={node}",
            f"-Cdiscovery.seed_hosts={hosts}",
            f"-Ccluster.initial_master_nodes={nodes[0]}",
            "-Cpsql.enabled=true",
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", f"{DIR}/data")

    def log_files(self, test, node):
        return [LOGFILE]


class CrateClient(jclient.Client):
    """_version-based ops over the pg wire (shared with the SQL
    machinery's drivers): version-divergence reads (value, _version)
    pairs per key; lost-updates does read-modify-write adds guarded by
    `AND _version = ?` — a 0-rowcount update is a definite CAS failure
    (lost_updates.clj:73-98)."""

    def __init__(self, mode: str, dialect: sql.Dialect | None = None,
                 node: str | None = None):
        self.mode = mode
        self.dialect = dialect or sql.PGDialect(port=5432, user="crate",
                                                database="doc")
        self.node = node
        self.conn = None
        self._setup_done = False

    def open(self, test, node):
        return CrateClient(self.mode, self.dialect, node)

    def _ensure_conn(self, test):
        if self.conn is None:
            self.conn = self.dialect.connect(self.node, test or {})
        if not self._setup_done:
            self.conn.query(
                "CREATE TABLE IF NOT EXISTS registers"
                " (id BIGINT PRIMARY KEY, val BIGINT)")
            self.conn.query(
                "CREATE TABLE IF NOT EXISTS lu_sets"
                " (id BIGINT PRIMARY KEY, elements TEXT)")
            self._setup_done = True

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def invoke(self, test, op):
        read_only = op.get("f") == "read"
        try:
            self._ensure_conn(test)
            return self._dispatch(op)
        except sql.DBError as e:
            ambiguous = str(e.code) in sql.AMBIGUOUS_SQL and not read_only
            return {**op, "type": "info" if ambiguous else "fail",
                    "error": f"crate-{e.code}: {e.message[:120]}"}
        except (sql.DriverError, OSError) as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}

    # space-separated int lists keep the elements column trivially
    # parseable on both ends (the reference round-trips JSON arrays)
    @staticmethod
    def _els_load(s) -> list[int]:
        return [int(x) for x in str(s or "").split()]

    @staticmethod
    def _els_dump(els: list[int]) -> str:
        return " ".join(str(x) for x in els)

    def _dispatch(self, op):
        kv = op["value"]
        k, v = (kv.key, kv.value) if independent.is_tuple(kv) \
            else (0, kv)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(kv) else (lambda x: x)
        c = self.conn
        if self.mode == "version-divergence":
            if op["f"] == "read":
                rows = sql._rows(c.query(
                    f'SELECT val, "_version" FROM registers '
                    f'WHERE id = {int(k)}'))
                out = None if not rows else \
                    {"value": int(rows[0][0]), "version": int(rows[0][1])}
                return {**op, "type": "ok", "value": lift(out)}
            if op["f"] == "write":
                c.query(self.dialect.upsert("registers", int(k), "val",
                                            str(int(v))))
                return {**op, "type": "ok"}
        if self.mode == "lost-updates":
            if op["f"] == "read":
                rows = sql._rows(c.query(
                    f"SELECT elements FROM lu_sets WHERE id = {int(k)}"))
                els = self._els_load(rows[0][0]) if rows else []
                return {**op, "type": "ok", "value": lift(sorted(els))}
            if op["f"] == "add":
                rows = sql._rows(c.query(
                    f'SELECT elements, "_version" FROM lu_sets '
                    f'WHERE id = {int(k)}'))
                if rows:
                    els = self._els_load(rows[0][0]) + [int(v)]
                    ver = int(rows[0][1])
                    res = c.query(
                        f"UPDATE lu_sets SET elements = "
                        f"'{self._els_dump(els)}' WHERE id = {int(k)} "
                        f"AND _version = {ver}")
                    n = _rowcount(res)
                    if n == 1:
                        return {**op, "type": "ok"}
                    if n == 0:   # version moved: CAS definitely lost
                        return {**op, "type": "fail",
                                "error": "version-conflict"}
                    return {**op, "type": "info",
                            "error": f"updated {n} rows!?"}
                try:
                    c.query(f"INSERT INTO lu_sets (id, elements) VALUES "
                            f"({int(k)}, '{self._els_dump([int(v)])}')")
                except sql.DBError as e:
                    if str(e.code) == "23505":   # concurrent create
                        return {**op, "type": "fail",
                                "error": "concurrent-create"}
                    raise
                return {**op, "type": "ok"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}


def _rowcount(res) -> int:
    """Rows affected, from the driver's command tag ('UPDATE 1')."""
    tags = [r.tag for r in res] if isinstance(res, list) else [res.tag]
    for t in reversed(tags):
        parts = (t or "").split()
        if parts and parts[-1].isdigit():
            return int(parts[-1])
    return 0


class MultiVersionChecker(jchecker.Checker):
    """version_divergence.clj:94-108: every observed (_version ->
    value) binding must be functional — two reads of one version with
    different values mean divergent replicas served the same version
    number."""

    def check(self, test, history, opts):
        by_version: dict = {}
        for o in history:
            if o.get("type") != "ok" or o.get("f") != "read":
                continue
            val = o.get("value")
            if not isinstance(val, dict) or val.get("version") is None:
                continue
            by_version.setdefault(val["version"], set()).add(val["value"])
        multis = {ver: sorted(vals) for ver, vals in by_version.items()
                  if len(vals) > 1}
        return {"valid?": not multis, "multis": multis,
                "version-count": len(by_version)}


def _incrementing_writes(f: str = "write"):
    """Per-key unique ascending values (version_divergence.clj:111-114
    / lost_updates.clj:106-109's iterate-inc writer)."""
    import itertools
    counter = itertools.count()

    def w(test=None, ctx=None):
        return {"type": "invoke", "f": f, "value": next(counter)}

    return w


def version_divergence_gen(opts: dict) -> gen.Generator:
    keys = range(int(opts.get("key-count", 100000)))
    return independent.concurrent_generator(
        int(opts.get("keys-concurrent", 10)), keys,
        lambda k: gen.reserve(
            int(opts.get("readers", 5)),
            gen.repeat_gen({"f": "read", "value": None}),
            _incrementing_writes()))


def lost_updates_gen(opts: dict) -> gen.Generator:
    """Per-key phases (lost_updates.clj:126-136): a burst of guarded
    adds, quiescence, then one final read per worker."""
    tl = float(opts.get("time-limit", 60))
    quiesce = float(opts.get("quiesce", 5))
    keys = range(int(opts.get("key-count", 100000)))
    # adds stop a second before the outer time limit minus quiescence,
    # so the final reads land INSIDE the suite's time_limit wrapper
    adds_window = max(0.5, tl - quiesce - 1.0)
    return independent.concurrent_generator(
        int(opts.get("keys-concurrent", 10)), keys,
        lambda k: gen.phases(
            gen.time_limit(adds_window,
                           gen.delay(0.01, _incrementing_writes("add"))),
            gen.sleep(quiesce),
            gen.each_thread(gen.once({"f": "read", "value": None}))))


def workloads(opts: dict | None = None) -> dict:
    opts = opts or {}
    std = standard_workloads(opts)
    out = {k: std[k] for k in
           ("register", "set", "wr", "monotonic", "long-fork")}
    out["version-divergence"] = lambda: {
        "client": CrateClient("version-divergence"),
        "generator": version_divergence_gen(opts),
        "checker": independent.checker(MultiVersionChecker()),
    }
    out["lost-updates"] = lambda: {
        "client": CrateClient("lost-updates"),
        "generator": lost_updates_gen(opts),
        "checker": independent.checker(jchecker.set_checker()),
    }
    return out


def default_client(workload: str, opts: dict):
    return sql.client_for(
        sql.PGDialect(port=5432, user="crate", database="doc"),
        workload, opts)


def crate_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "register")
    # the _version workloads carry their own client; suite_test falls
    # back to wl["client"] when the explicit argument is None
    client = opts.get("client") or (
        default_client(wname, opts)
        if wname not in ("version-divergence", "lost-updates") else None)
    return suite_test(
        "crate", wname, opts, workloads(opts),
        db=CrateDB(opts.get("version", VERSION)),
        client=client,
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: crate_test(
            {**tmap,
             "workload": resolve_workload(args, tmap, "register")}),
        name="crate",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

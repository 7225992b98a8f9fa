"""The port's SQL wire drivers (`drivers/pgwire.py`, `drivers/mysql_wire.py`)
and SQL client (`suites/sql.py`) against the reference's, over the
in-process fake servers of `tests/fake_sql.py`.

- The drivers: the same statements through both packages' drivers give
  the same results and errors; the reference's `tests/test_drivers.py`
  run on the port (auth paths: trust, cleartext, MD5, SCRAM and mysql's
  native password).
- The client, completion for completion: every workload mode's ops
  through both packages' `SQLClient`, each against a fresh fake server.
- Whole suites, held by verdict: `cockroach` register and bank, `tidb`
  append, table and register with its option knobs, run threaded
  through the port's `core.run` on `device="cpu"`, and the stored
  history re-checked by the reference's checker for that workload.
- The rest of the reference's `tests/test_sql_client.py`, on the port.
"""

import dataclasses
import threading

import pytest

import jepsen_tpu.drivers as ref_drivers
import jepsen_tpu.drivers.mysql_wire as ref_mysql
import jepsen_tpu.drivers.pgwire as ref_pg
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.suites.cockroach as ref_cockroach
import jepsen_tpu.suites.sql as ref_sql
import jepsen_tpu.suites.tidb as ref_tidb
import jepsen_tpu_torch.core as port_core
import jepsen_tpu_torch.drivers as port_drivers
import jepsen_tpu_torch.drivers.mysql_wire as port_mysql
import jepsen_tpu_torch.drivers.pgwire as port_pg
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.net as port_net
import jepsen_tpu_torch.suites.cockroach as port_cockroach
import jepsen_tpu_torch.suites.sql as port_sql
import jepsen_tpu_torch.suites.tidb as port_tidb
from jepsen_tpu_torch import cli
from jepsen_tpu_torch.drivers import DBError, DriverError, is_retriable
from jepsen_tpu_torch.store import Store
from jepsen_tpu_torch.workloads.comments import CommentsChecker

from fake_sql import FakeMySQLServer, FakePGServer, MiniDB
from test_torch_cli import reference_env  # noqa: F401
from test_torch_suites import no_threads_left, ref_recheck

REF = dict(pg=ref_pg, mysql=ref_mysql, drivers=ref_drivers, sql=ref_sql,
           ind=ref_ind, cockroach=ref_cockroach, tidb=ref_tidb)
PORT = dict(pg=port_pg, mysql=port_mysql, drivers=port_drivers,
            sql=port_sql, ind=port_ind, cockroach=port_cockroach,
            tidb=port_tidb)
NODES = ("n1", "n2", "n3", "n4", "n5")


def server(kind: str, **kw):
    return FakePGServer(**kw) if kind == "pg" else FakeMySQLServer(**kw)


# ---------------------------------------------------------------------------
# The drivers: both packages on the same statements
# ---------------------------------------------------------------------------

PG_STMTS = [
    "CREATE TABLE IF NOT EXISTS registers (id BIGINT PRIMARY KEY, "
    "val BIGINT)",
    "INSERT INTO registers (id, val) VALUES (1, 10)",
    "SELECT val FROM registers WHERE id = 1",
    "INSERT INTO registers (id, val) VALUES (1, 11)",
    "INSERT INTO registers (id, val) VALUES (2, 20) ON CONFLICT (id) DO "
    "UPDATE SET val = excluded.val",
    "SELECT id, val FROM registers",
    "CREATE TABLE IF NOT EXISTS lists (id BIGINT PRIMARY KEY, val TEXT); "
    "INSERT INTO lists (id, val) VALUES (7, NULL); "
    "SELECT id, val FROM lists WHERE id = 7",
    "BEGIN", "UPDATE registers SET val = val + 5 WHERE id = 1", "COMMIT",
    "SELECT val FROM registers WHERE id = 1",
    "SELECT nonsense syntax here",
    "SELECT 1",
]
MY_STMTS = [s for s in PG_STMTS if "ON CONFLICT" not in s
            and ";" not in s] + [
    "CREATE TABLE IF NOT EXISTS lists (id BIGINT PRIMARY KEY, val TEXT)",
    "INSERT INTO lists (id, val) VALUES (9, '1') ON DUPLICATE KEY UPDATE "
    "val = CONCAT(val, ',', VALUES(val))",
    "INSERT INTO lists (id, val) VALUES (9, '2') ON DUPLICATE KEY UPDATE "
    "val = CONCAT(val, ',', VALUES(val))",
    "SELECT val FROM lists WHERE id = 9",
    "INSERT INTO lists (id, val) VALUES (3, NULL)",
    "SELECT val FROM lists WHERE id = 3",
    "SET @@tidb_retry_limit = 0",
]


def outcome(P, conn, kind: str, stmt: str):
    """A statement's result fields, or its error's class and code."""
    try:
        res = conn.query(stmt)
    except P["drivers"].DBError as e:
        return ("DBError", e.code, e.message)
    except P["drivers"].DriverError as e:
        return ("DriverError", str(e))
    res = res if isinstance(res, list) else [res]
    return [dataclasses.asdict(r) for r in res]


@pytest.mark.parametrize("kind,auth", [
    ("pg", "trust"), ("pg", "cleartext"), ("pg", "md5"), ("pg", "scram"),
    ("mysql", ""), ("mysql", "native")])
def test_driver_results_equal_the_references(kind, auth):
    password = "hunter2" if auth not in ("trust", "") else ""
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        kw = ({"auth": auth, "password": password} if kind == "pg"
              else {"password": password})
        with server(kind, **kw) as srv:
            mod = P["pg"] if kind == "pg" else P["mysql"]
            conn = mod.connect("127.0.0.1", srv.port, user="root",
                               password=password or None if kind == "pg"
                               else password)
            stmts = PG_STMTS if kind == "pg" else MY_STMTS
            got[name] = [outcome(P, conn, kind, s) for s in stmts]
            conn.close()
            got[name].append(outcome(P, conn, kind, "SELECT 1"))
            got[name].append(srv.db.session_sets)
    assert got["port"] == got["ref"]
    assert got["port"][-2][0] == "DriverError"


@pytest.mark.parametrize("kind,auth", [("pg", "cleartext"), ("pg", "md5"),
                                       ("pg", "scram"), ("mysql", "")])
def test_bad_password_equals_the_references(kind, auth):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        kw = {"auth": auth} if kind == "pg" else {}
        with server(kind, password="right", **kw) as srv:
            mod = P["pg"] if kind == "pg" else P["mysql"]
            with pytest.raises(P["drivers"].DBError) as e:
                mod.connect("127.0.0.1", srv.port, password="wrong")
            got[name] = (e.value.code, e.value.message)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("code", ["40001", "40P01", "23505", "42601", 1062,
                                  1213, 1205, 8022, 8028, 9007, 1146, 2013])
def test_is_retriable_equals_the_references(code):
    assert port_drivers.is_retriable(port_drivers.DBError(code, "m")) == \
        ref_drivers.is_retriable(ref_drivers.DBError(code, "m"))
    assert not port_drivers.is_retriable(port_drivers.DriverError("x"))


# ---------------------------------------------------------------------------
# The reference's tests/test_drivers.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("auth,password", [
    ("trust", None), ("cleartext", "hunter2"), ("md5", "hunter2"),
    ("scram", "hunter2")])
def test_pg_auth_and_query(auth, password):
    with FakePGServer(auth=auth, password=password or "") as srv:
        conn = port_pg.connect("127.0.0.1", srv.port, user="root",
                               database="defaultdb", password=password)
        conn.query("CREATE TABLE IF NOT EXISTS registers"
                   " (id BIGINT PRIMARY KEY, val BIGINT)")
        conn.query("INSERT INTO registers (id, val) VALUES (1, 10)")
        res = conn.exec("SELECT val FROM registers WHERE id = 1")
        assert res.rows == [["10"]]
        assert res.columns == ["val"]
        assert res.tag == "SELECT 1"
        conn.close()


def test_pg_error_mapping_and_recovery():
    with FakePGServer() as srv:
        conn = port_pg.connect("127.0.0.1", srv.port)
        conn.query("CREATE TABLE IF NOT EXISTS sets"
                   " (val BIGINT PRIMARY KEY)")
        conn.query("INSERT INTO sets (val) VALUES (1)")
        with pytest.raises(DBError) as ei:
            conn.query("INSERT INTO sets (val) VALUES (1)")
        assert ei.value.code == "23505"
        assert is_retriable(ei.value)
        assert conn.exec("SELECT val FROM sets").rows == [["1"]]
        conn.close()


def test_pg_connection_refused():
    with pytest.raises((DriverError, OSError)):
        port_pg.connect("127.0.0.1", 1, timeout=0.5)


def test_pg_closed_conn_raises_driver_error():
    with FakePGServer() as srv:
        conn = port_pg.connect("127.0.0.1", srv.port)
        conn.close()
        with pytest.raises(DriverError):
            conn.query("SELECT 1")


@pytest.mark.parametrize("password", ["", "sekrit"])
def test_mysql_auth_and_query(password):
    with FakeMySQLServer(password=password) as srv:
        conn = port_mysql.connect("127.0.0.1", srv.port, user="root",
                                  password=password)
        conn.query("CREATE TABLE IF NOT EXISTS registers"
                   " (id BIGINT PRIMARY KEY, val BIGINT)")
        r = conn.query("INSERT INTO registers (id, val) VALUES (2, 20)")
        assert r.affected_rows == 1
        res = conn.query("SELECT id, val FROM registers WHERE id = 2")
        assert res.columns == ["id", "val"]
        assert res.rows == [["2", "20"]]
        conn.close()


def test_mysql_null_and_error():
    with FakeMySQLServer() as srv:
        conn = port_mysql.connect("127.0.0.1", srv.port)
        conn.query("CREATE TABLE IF NOT EXISTS lists"
                   " (id BIGINT PRIMARY KEY, val TEXT)")
        conn.query("INSERT INTO lists (id, val) VALUES (3, NULL)")
        assert conn.query("SELECT val FROM lists WHERE id = 3"
                          ).rows == [[None]]
        with pytest.raises(DBError) as ei:
            conn.query("INSERT INTO lists (id, val) VALUES (3, 'x')")
        assert ei.value.code == 1062
        assert is_retriable(ei.value)
        assert conn.query("SELECT id FROM lists WHERE id = 3"
                          ).rows == [["3"]]
        conn.close()


def test_minidb_txn_isolation_through_the_ports_driver():
    """BEGIN..COMMIT on one connection excludes the other's statements."""
    db = MiniDB()
    with FakePGServer(db=db) as srv:
        a = port_pg.connect("127.0.0.1", srv.port)
        b = port_pg.connect("127.0.0.1", srv.port)
        a.query("CREATE TABLE IF NOT EXISTS counter"
                " (id BIGINT PRIMARY KEY, val BIGINT)")
        a.query("INSERT INTO counter (id, val) VALUES (0, 0)")
        a.query("BEGIN")
        assert a.exec("SELECT val FROM counter WHERE id = 0").rows == [["0"]]
        done = threading.Event()
        t = threading.Thread(target=lambda: (b.query(
            "UPDATE counter SET val = val + 5 WHERE id = 0"), done.set()),
            daemon=True)
        t.start()
        assert not done.wait(0.2)
        a.query("UPDATE counter SET val = val + 1 WHERE id = 0")
        a.query("COMMIT")
        assert done.wait(2.0)
        t.join()
        assert a.exec("SELECT val FROM counter WHERE id = 0"
                      ).rows == [["6"]]
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# The SQL client, completion for completion
# ---------------------------------------------------------------------------

def norm(P, v):
    """A completion's value with lifted tuples marked, so both packages'
    Tuple classes compare alike (and unlike a plain pair)."""
    if P["ind"].is_tuple(v):
        return ["tuple", norm(P, v.key), norm(P, v.value)]
    if isinstance(v, dict):
        return {k: norm(P, x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(P, x) for x in v]
    return v


def op_script(P, mode: str) -> list:
    """Ops of every kind the mode's workload sends, lifted where the
    workload lifts them, some of them failing."""
    t = P["ind"].tuple_
    if mode == "register":
        return [("read", None), ("write", 3), ("read", None),
                ("cas", [3, 4]), ("cas", [3, 9]), ("read", None),
                ("write", t(7, 42)), ("read", t(7, None)),
                ("cas", t(7, [42, 1])), ("read", t(7, None)),
                ("bogus", 1)]
    if mode == "append":
        return [("txn", [["append", 1, 10], ["r", 1, None]]),
                ("txn", [["append", 1, 11], ["r", 1, None],
                         ["append", 2, 1]]),
                ("txn", [["r", 2, None], ["r", 3, None]]),
                ("txn", [["x", 1, 1]])]
    if mode == "wr":
        return [("txn", [["w", 5, 1], ["r", 5, None], ["r", 6, None]]),
                ("txn", [["w", 6, 2], ["w", 5, 3], ["r", 5, None]]),
                ("read", [["r", 6, None]])]
    if mode == "bank":
        return [("read", None),
                ("transfer", {"from": 0, "to": 3, "amount": 5}),
                ("read", None),
                ("transfer", {"from": 6, "to": 0, "amount": 99}),
                ("transfer", {"from": 3, "to": 6, "amount": 5}),
                ("read", None), ("bogus", None)]
    if mode == "set":
        return [("add", 1), ("add", 2), ("add", 2), ("read", None)]
    if mode == "monotonic":
        return [("read", None), ("inc", None), ("inc", None),
                ("read", None)]
    if mode == "sequential":
        return [("write", t(2, 7)), ("write", t(2, 8)), ("read", t(2, None)),
                ("read", t(3, None))]
    if mode == "g2":
        return [("insert", t(1, [10, None])), ("insert", t(1, [None, 11])),
                ("insert", t(2, [None, 12]))]
    if mode == "comments":
        return [("write", t(3, 4)), ("write", t(3, 17)),
                ("read", t(3, None)), ("read", t(9, None))]
    if mode == "table":
        return [("insert", [7, 0]), ("create-table", 7), ("insert", [7, 0]),
                ("insert", [7, 0]), ("create-table", 8)]
    assert mode == "dirty-reads"
    return [("read", None), ("write", 1), ("read", None), ("write", 2),
            ("read", None)]


MODES = ["register", "append", "wr", "bank", "set", "monotonic",
         "sequential", "g2", "comments", "table", "dirty-reads"]


def client_run(P, kind: str, mode: str) -> list:
    with server(kind) as srv:
        dialect = (P["sql"].PGDialect(port=srv.port) if kind == "pg"
                   else P["sql"].MySQLDialect(port=srv.port))
        test = {"db-hosts": {n: ("127.0.0.1", srv.port) for n in NODES}}
        c = P["sql"].SQLClient(dialect, mode).open(test, "n1")
        out = [c.invoke(test, {"type": "invoke", "f": f, "value": v,
                               "process": 0})
               for f, v in op_script(P, mode)]
        c.close(test)
    return [{**o, "value": norm(P, o.get("value"))} for o in out]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["pg", "mysql"])
def test_client_completions_equal_the_references(kind, mode):
    ref = client_run(REF, kind, mode)
    port = client_run(PORT, kind, mode)
    assert port == ref
    assert any(o["type"] == "ok" for o in port)


def test_down_db_maps_to_info_and_fail():
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        c = P["sql"].SQLClient(P["sql"].PGDialect(port=1), "register",
                               node="n1")
        c.dialect.timeout = 0.3
        test = {"db-hosts": {"n1": ("127.0.0.1", 1)}}
        got[name] = [c.invoke(test, {"type": "invoke", "f": f, "value": v,
                                     "process": 0})["type"]
                     for f, v in (("write", 1), ("read", None))]
    assert got["port"] == got["ref"] == ["info", "fail"]


@pytest.mark.parametrize("workload", sorted(port_sql.MODES))
def test_client_for_equals_the_references(workload):
    opts = {"accounts": [0, 1, 2], "total-amount": 30,
            "sql-opts": {"read_lock": "FOR UPDATE"}}
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        c = P["sql"].client_for(P["sql"].MySQLDialect(), workload, opts)
        got[name] = (c.mode, c.accounts, c.total, c.sql_opts,
                     c.dialect.setup_stmts())
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# Whole suites against the fakes, held by verdict
# ---------------------------------------------------------------------------

def run_suite(tmp_path, make_test, srv, workload, extra=None, device="cpu"):
    """The reference's `run_suite` helper (tests/test_sql_client.py), on
    the port: the fakes have no daemons to install, so db, os and the
    nemesis go; the checkers run on `device`."""
    opts = {
        "workload": workload,
        "ssh": {"dummy": True},
        "time-limit": 1.5,
        "extra": {"db": None, "os": None, "nemesis": None,
                  "net": port_net.noop(),
                  "store": Store(tmp_path / "port")},
        "db-hosts": {n: ("127.0.0.1", srv.port) for n in NODES},
        **({"device": device} if device else {}),
        **(extra or {}),
    }
    test = make_test(opts)
    for k in ("db", "os", "nemesis"):
        test.pop(k, None)
    return port_core.run(test)


def verdict(res: dict) -> tuple:
    return (res.get("valid?"), res.get("anomaly-types"),
            res.get("failures"), res.get("bad-read-count"),
            res.get("error-count"))


@pytest.mark.parametrize("suite,workload,options", [
    ("cockroach", "register", None), ("cockroach", "bank", None),
    ("cockroach", "comments", None), ("tidb", "append", None),
    ("tidb", "table", None), ("tidb", "wr", None),
    ("tidb", "register", {"auto-retry": False, "auto-retry-limit": 0,
                          "read-lock": "FOR UPDATE"}),
    ("tidb", "bank", {"update-in-place": False, "read-lock": "FOR UPDATE"}),
], ids=lambda x: x if isinstance(x, str) else ("opts" if x else "plain"))
def test_suite_run_verdict_equals_the_references(suite, workload, options,
                                                 tmp_path, reference_env,
                                                 monkeypatch):
    kind = "pg" if suite == "cockroach" else "mysql"
    make = (port_cockroach.cockroach_test if suite == "cockroach"
            else port_tidb.tidb_test)
    before = set(threading.enumerate())
    extra = {"workload-options": options} if options else {}
    if workload == "comments":
        extra["time-limit"] = 2.0
    with server(kind) as srv:
        test = run_suite(tmp_path, make, srv, workload, extra)
        sets = srv.db.session_sets
    assert no_threads_left(before)
    res = test["results"]
    assert res["valid?"] is True, res
    assert any(o.get("type") == "ok" for o in test["history"])
    rc, ref_res = ref_recheck(suite, test["store"].test_dir(test),
                              tmp_path, workload, monkeypatch)
    assert verdict(res) == verdict(ref_res)
    assert rc == cli.validity_exit_code(res)
    if workload == "register":
        assert {str(k): r["valid?"] for k, r in res["results"].items()} \
            == {k: r["valid?"] for k, r in ref_res["results"].items()}
    if options and "auto-retry" in options:
        assert any("tidb_disable_txn_auto_retry = 1" in s for s in sets)
        assert any("tidb_retry_limit = 0" in s for s in sets)
    if workload == "comments":
        assert any(v.get("comments", {}).get("valid?") is True
                   for v in res["results"].values())
    if workload == "table":
        ok = {o["f"] for o in test["history"] if o.get("type") == "ok"}
        assert {"create-table", "insert"} <= ok


# ---------------------------------------------------------------------------
# The rest of the reference's tests/test_sql_client.py, on the port
# ---------------------------------------------------------------------------

def test_tidb_option_matrix_equals_the_references():
    for tier in ("full", "expected", "quick"):
        port = port_tidb.all_tests(tier=tier)
        ref = ref_tidb.all_tests(tier=tier)
        assert [(t["name"], t.get("workload-options"), t["workload"])
                for t in port] == [(t["name"], t.get("workload-options"),
                                    t["workload"]) for t in ref]
    full = port_tidb.all_tests(tier="full")
    assert len(full) == sum(
        len(port_tidb.option_combos(port_tidb.WORKLOAD_OPTIONS[w]))
        for w in port_tidb.workloads())
    assert all(tm["workload-options"]["auto-retry"] is False
               for tm in port_tidb.all_tests(tier="expected"))
    assert len(port_tidb.all_tests(tier="quick")) == len(
        port_tidb.workloads())
    assert len({tm["name"] for tm in full}) == len(full)


@pytest.mark.parametrize("combo", [{}, {"auto-retry": True},
                                   {"auto-retry": False,
                                    "auto-retry-limit": 0},
                                   {"auto-retry-limit": None}], ids=str)
def test_tidb_session_stmts_equal_the_references(combo):
    assert port_tidb._session_stmts(combo) == ref_tidb._session_stmts(combo)


def test_table_checker_verdicts():
    c = port_tidb.TableChecker()
    ok_hist = [
        {"type": "ok", "f": "create-table", "value": 1},
        {"type": "ok", "f": "insert", "value": [1, 0]},
        {"type": "fail", "f": "insert", "value": [1, 0],
         "error": "duplicate-key"},
    ]
    assert c.check({}, ok_hist, {})["valid?"] is True
    bad = ok_hist + [{"type": "fail", "f": "insert", "value": [1, 0],
                      "error": "doesnt-exist"}]
    res = c.check({}, bad, {})
    assert res == ref_tidb.TableChecker().check({}, bad, {})
    assert res["valid?"] is False and res["error-count"] == 1


def test_table_generator_tracks_acked_creates():
    """The table generator, op for op against the reference's, with
    creates acked as they come."""
    import random
    import jepsen_tpu.generator as ref_gen
    got = {}
    for name, (T, G) in (("ref", (ref_tidb, ref_gen)),
                         ("port", (port_tidb, port_gen))):
        random.seed(5)
        g = T.table_workload({})["generator"]
        test = {"concurrency": 2, "nodes": ["n1"]}
        ctx = G.Context.for_test(test)
        ops = []
        for _ in range(40):
            o, g = G.op(g, test, ctx)
            ops.append({k: v for k, v in o.items() if k != "time"})
            if o["f"] == "create-table":
                g = G.update(g, test, ctx, {**o, "type": "ok"})
        got[name] = ops
    assert got["port"] == got["ref"]
    assert got["port"][0]["f"] == "create-table"
    assert "insert" in {o["f"] for o in got["port"]}


def test_comments_checker_verdicts():
    c = CommentsChecker()

    def w(id_, ty):
        return {"type": ty, "f": "write", "value": id_, "process": 0}

    def rd(seen):
        return {"type": "ok", "f": "read", "value": seen, "process": 1}

    hist = [w(0, "invoke"), w(0, "ok"), w(1, "invoke"), w(1, "ok")]
    assert c.check({}, hist + [rd([0, 1]), rd([0]), rd([])],
                   {})["valid?"] is True
    bad = c.check({}, hist + [rd([1])], {})
    assert bad["valid?"] is False
    assert bad["errors"][0]["missing"] == [0]
    conc = [w(0, "invoke"), w(1, "invoke"), w(0, "ok"), w(1, "ok")]
    assert c.check({}, conc + [rd([1])], {})["valid?"] is True


def test_registries_have_their_signature_workloads():
    assert "comments" in port_cockroach.workloads({})
    assert "table" in port_tidb.workloads({})
    assert sorted(port_cockroach.workloads({})) == sorted(
        ref_cockroach.workloads({}))
    assert sorted(port_tidb.workloads({})) == sorted(ref_tidb.workloads({}))

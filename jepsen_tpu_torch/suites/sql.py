"""Generic SQL client: maps workload ops onto SQL transactions.

This is the counterpart of the per-DB client namespaces in the
reference's SQL suites (cockroachdb/src/jepsen/cockroach/client.clj:1-60
conn management + retries; tidb/src/tidb/sql.clj; yugabyte YSQL client),
built on the in-tree wire drivers (drivers.pgwire / drivers.mysql_wire)
instead of jdbc.

One `SQLClient` serves every workload in the shared registry. The op
vocabulary it understands (values may be independent-lifted `[k, v]`):

    read/write/cas          register ops           -> registers table
    txn [[f k v] ...]       elle append / wr mops  -> lists / registers
    read/transfer           bank                   -> accounts
    add/read                set                    -> sets
    read/inc                monotonic              -> counter
    write/read (lifted)     causal-reverse         -> cr
    insert (lifted [a,b])   adya g2                -> g2a / g2b

Error mapping follows drivers.__init__: DBError => the statement/txn was
definitely rejected => type "fail"; DriverError (conn loss/timeout) =>
indeterminate => "info" (reads may safely "fail").

The port's copy of `jepsen_tpu/suites/sql.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import random

from .. import client as jclient
from .. import independent
from ..drivers import DBError, DriverError
from ..workloads.comments import TABLE_COUNT

#: Error codes whose outcome is UNKNOWN: the txn may have committed.
#: pg 40003 = statement_completion_unknown (cockroach's "result is
#: ambiguous" commit errors); mysql 2013/2006-style losses arrive as
#: DriverError already.
AMBIGUOUS_SQL = {"40003"}


def resolve(node: str, default_port: int, test: dict) -> tuple[str, int]:
    """Node name -> (host, port). Tests (and NATed clusters) may remap
    via test["db-hosts"] = {node: "host" | ("host", port)}."""
    remap = (test or {}).get("db-hosts", {}).get(node, node)
    if isinstance(remap, (tuple, list)):
        return remap[0], int(remap[1])
    return remap, default_port


class Dialect:
    """SQL syntax + session knobs that differ across engines."""

    name = "generic"
    port = 5432

    def connect(self, node: str, test: dict):
        raise NotImplementedError

    def begin(self) -> str:
        return "BEGIN"

    def commit(self) -> str:
        return "COMMIT"

    def rollback(self) -> str:
        return "ROLLBACK"

    def begin_serializable(self) -> list[str]:
        """Statements opening a SERIALIZABLE txn (the isolation the
        dirty-reads workload runs under, dirty_reads.clj:51-52)."""
        return [self.begin()]

    def upsert(self, table: str, key: int, col: str, val: str) -> str:
        raise NotImplementedError

    def upsert_concat(self, table: str, key: int, val: int) -> str:
        """Append `val` to a comma-joined list column."""
        raise NotImplementedError

    def setup_stmts(self) -> list[str]:
        return [
            "CREATE TABLE IF NOT EXISTS registers"
            " (id BIGINT PRIMARY KEY, val BIGINT)",
            "CREATE TABLE IF NOT EXISTS lists"
            " (id BIGINT PRIMARY KEY, val TEXT)",
            "CREATE TABLE IF NOT EXISTS accounts"
            " (id BIGINT PRIMARY KEY, balance BIGINT)",
            "CREATE TABLE IF NOT EXISTS sets (val BIGINT PRIMARY KEY)",
            "CREATE TABLE IF NOT EXISTS counter"
            " (id BIGINT PRIMARY KEY, val BIGINT)",
            "CREATE TABLE IF NOT EXISTS cr"
            " (k BIGINT, v BIGINT, PRIMARY KEY (k, v))",
            "CREATE TABLE IF NOT EXISTS g2a"
            " (id BIGINT PRIMARY KEY, k BIGINT)",
            "CREATE TABLE IF NOT EXISTS g2b"
            " (id BIGINT PRIMARY KEY, k BIGINT)",
            "CREATE TABLE IF NOT EXISTS dirty"
            " (id BIGINT PRIMARY KEY, x BIGINT NOT NULL)",
        ]


class PGDialect(Dialect):
    """CockroachDB (--insecure trust auth) and YugabyteDB YSQL."""

    name = "pg"

    def __init__(self, port: int = 26257, user: str = "root",
                 database: str = "defaultdb", password: str | None = None,
                 timeout: float = 10.0):
        self.port, self.user, self.database = port, user, database
        self.password, self.timeout = password, timeout

    def connect(self, node: str, test: dict):
        from ..drivers import pgwire
        host, port = resolve(node, self.port, test)
        return pgwire.connect(host, port, user=self.user,
                              database=self.database,
                              password=self.password,
                              timeout=self.timeout)

    def begin_serializable(self):
        return ["BEGIN ISOLATION LEVEL SERIALIZABLE"]

    def upsert(self, table, key, col, val):
        return (f"INSERT INTO {table} (id, {col}) VALUES ({key}, {val}) "
                f"ON CONFLICT (id) DO UPDATE SET {col} = excluded.{col}")

    def upsert_concat(self, table, key, val):
        return (f"INSERT INTO {table} (id, val) VALUES ({key}, '{val}') "
                f"ON CONFLICT (id) DO UPDATE SET val = "
                f"{table}.val || ',' || excluded.val")


class MySQLDialect(Dialect):
    """TiDB (mysql protocol, root/no password by default).
    `session_stmts` run once per connection — the hook tidb's
    option sweeps use for `SET @@tidb_...` knobs (tidb/sql.clj)."""

    name = "mysql"

    def __init__(self, port: int = 4000, user: str = "root",
                 database: str = "test", password: str = "",
                 timeout: float = 10.0,
                 session_stmts: list[str] | None = None):
        self.port, self.user, self.database = port, user, database
        self.password, self.timeout = password, timeout
        self.session_stmts = list(session_stmts or [])

    def connect(self, node: str, test: dict):
        from ..drivers import mysql_wire
        host, port = resolve(node, self.port, test)
        return mysql_wire.connect(host, port, user=self.user,
                                  database=self.database,
                                  password=self.password,
                                  timeout=self.timeout)

    def begin_serializable(self):
        return ["SET TRANSACTION ISOLATION LEVEL SERIALIZABLE",
                self.begin()]

    def upsert(self, table, key, col, val):
        return (f"INSERT INTO {table} (id, {col}) VALUES ({key}, {val}) "
                f"ON DUPLICATE KEY UPDATE {col} = VALUES({col})")

    def upsert_concat(self, table, key, val):
        return (f"INSERT INTO {table} (id, val) VALUES ({key}, '{val}') "
                f"ON DUPLICATE KEY UPDATE val = "
                f"CONCAT(val, ',', VALUES(val))")


def _rows(res) -> list:
    """Normalize driver Result(s) to a row list (pg query returns a
    list of Results, mysql a single Result)."""
    if isinstance(res, list):
        return res[-1].rows if res else []
    return res.rows


class SQLClient(jclient.Client):
    """One connection per worker; lazy connect so a down DB surfaces as
    op-level "info"/"fail", not a setup crash (client.clj's open!/close!
    contract)."""

    def __init__(self, dialect: Dialect, mode: str = "register",
                 accounts: list | None = None, total: int = 100,
                 node: str | None = None,
                 sql_opts: dict | None = None):
        self.dialect = dialect
        self.mode = mode
        self.accounts = accounts if accounts is not None else list(range(8))
        self.total = total
        self.node = node
        # Workload-option knobs (tidb/core.clj:47-79 sweeps these):
        #   read_lock:        None | "FOR UPDATE" (suffix on txn reads)
        #   update_in_place:  bank transfers use server-side arithmetic
        self.sql_opts = dict(sql_opts or {})
        self.conn = None
        self._setup_done = False

    # -- lifecycle -----------------------------------------------------

    def open(self, test, node):
        return SQLClient(self.dialect, self.mode, self.accounts,
                         self.total, node, self.sql_opts)

    def _lock(self) -> str:
        rl = self.sql_opts.get("read_lock")
        return f" {rl}" if rl else ""

    def setup(self, test):
        pass  # schema created lazily on first invoke (first conn wins)

    def _ensure_conn(self, test):
        if self.conn is None:
            self.conn = self.dialect.connect(self.node, test or {})
            for stmt in getattr(self.dialect, "session_stmts", ()):
                self.conn.query(stmt)
        if not self._setup_done:
            for stmt in self.dialect.setup_stmts():
                self.conn.query(stmt)
            if self.mode == "dirty-reads":
                # Seed every row to -1 exactly once, insert-if-absent
                # (dirty_reads.clj:37-43's dotimes insert loop).
                d = self.dialect
                noop = ("ON CONFLICT (id) DO NOTHING" if d.name == "pg"
                        else "ON DUPLICATE KEY UPDATE x = x")
                for i in range(self._dirty_rows()):
                    self.conn.query(
                        f"INSERT INTO dirty (id, x) VALUES ({i}, -1) "
                        f"{noop}")
            if self.mode == "comments":
                # ids shard across several tables so rows land in
                # different ranges (comments.clj:30-40)
                for i in range(TABLE_COUNT):
                    self.conn.query(
                        f"CREATE TABLE IF NOT EXISTS comment_{i}"
                        " (id BIGINT PRIMARY KEY, k BIGINT)")
            if self.mode == "bank":
                # Atomic insert-if-absent seeding: account 0 holds the
                # full total, the rest 0. Concurrent seeders can't reset
                # balances mid-run (the upsert clause never fires a
                # write), so the sum is `total` from the first seed on.
                d = self.dialect
                noop = ("ON CONFLICT (id) DO NOTHING" if d.name == "pg"
                        else "ON DUPLICATE KEY UPDATE balance = balance")
                for a, bal in [(0, self.total)] + [
                        (a, 0) for a in self.accounts if a != 0]:
                    self.conn.query(
                        f"INSERT INTO accounts (id, balance) "
                        f"VALUES ({int(a)}, {bal}) {noop}")
            self._setup_done = True

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def teardown(self, test):
        pass

    # -- op dispatch ---------------------------------------------------

    def invoke(self, test, op):
        f = op.get("f")
        # Reads never wrote anything: indeterminate errors are safe to
        # report as definite failures (client.clj / etcd.clj:118).
        read_only = f in ("read",) and self.mode != "monotonic"
        try:
            self._ensure_conn(test)
            return self._dispatch(op)
        except DBError as e:
            # Most backend errors are definite rejections -> fail; the
            # ambiguous-commit SQLSTATEs mean the txn may have applied
            # -> info for writes (cockroach/client.clj's retry loop
            # makes the same distinction).
            ambiguous = str(e.code) in AMBIGUOUS_SQL and not read_only
            return {**op, "type": "info" if ambiguous else "fail",
                    "error": f"{self.dialect.name}-"
                    f"{e.code}: {e.message[:120]}"}
        except DriverError as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}
        except OSError as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}

    def _dispatch(self, op):
        f = op.get("f")
        mode = self.mode
        # append/wr modes carry [f k v] micro-op lists whatever the op's
        # f is (long-fork uses f="read"/"write" with mop values).
        if f == "txn" or mode in ("append", "wr"):
            return self._txn(op)
        if mode == "bank":
            return self._bank(op)
        if mode == "set":
            return self._set(op)
        if mode == "dirty-reads":
            return self._dirty_reads(op)
        if mode == "table":
            return self._table(op)
        if mode == "comments":
            return self._comments(op)
        if mode == "monotonic":
            return self._monotonic(op)
        if mode in ("sequential", "causal-reverse"):
            return self._causal_reverse(op)
        if f == "insert":
            return self._g2(op)
        return self._register(op)

    # -- register (read/write/cas) -------------------------------------

    def _register(self, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        c, d = self.conn, self.dialect
        if op["f"] == "read":
            rows = _rows(c.query(
                f"SELECT val FROM registers WHERE id = {int(k)}"))
            out = int(rows[0][0]) if rows and rows[0][0] is not None \
                else None
            return {**op, "type": "ok", "value": lift(out)}
        if op["f"] == "write":
            c.query(d.upsert("registers", int(k), "val", str(int(val))))
            return {**op, "type": "ok"}
        if op["f"] == "cas":
            old, new = val
            c.query(d.begin())
            try:
                rows = _rows(c.query(
                    f"SELECT val FROM registers WHERE id = {int(k)}"
                    f"{self._lock()}"))
                cur = int(rows[0][0]) if rows and rows[0][0] is not None \
                    else None
                if cur != old:
                    c.query(d.rollback())
                    return {**op, "type": "fail", "error": "precondition"}
                c.query(f"UPDATE registers SET val = {int(new)} "
                        f"WHERE id = {int(k)}")
                c.query(d.commit())
                return {**op, "type": "ok"}
            except DBError:
                self._try_rollback()
                raise
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    # -- elle txns ([f k v] micro-ops) ---------------------------------

    def _txn(self, op):
        mops = op["value"]
        v = mops
        k0 = None
        if independent.is_tuple(mops):
            k0, mops = mops.key, mops.value
        c, d = self.conn, self.dialect
        c.query(d.begin())
        out = []
        try:
            for mop in mops:
                mf, mk, mv = mop[0], mop[1], mop[2]
                if mf == "append":
                    c.query(d.upsert_concat("lists", int(mk), int(mv)))
                    out.append([mf, mk, mv])
                elif mf == "w":
                    c.query(d.upsert("registers", int(mk), "val",
                                     str(int(mv))))
                    out.append([mf, mk, mv])
                elif mf == "r" and self.mode == "append":
                    rows = _rows(c.query(
                        f"SELECT val FROM lists WHERE id = {int(mk)}"
                        f"{self._lock()}"))
                    txt = rows[0][0] if rows else None
                    vals = [int(x) for x in txt.split(",")] if txt else []
                    out.append([mf, mk, vals])
                elif mf == "r":
                    rows = _rows(c.query(
                        f"SELECT val FROM registers WHERE id = {int(mk)}"
                        f"{self._lock()}"))
                    rv = int(rows[0][0]) if rows and rows[0][0] is not None \
                        else None
                    out.append([mf, mk, rv])
                else:
                    raise DBError("XXMOP", f"unknown micro-op {mf!r}")
            c.query(d.commit())
        except DBError:
            self._try_rollback()
            raise
        new_v = independent.tuple_(k0, out) if k0 is not None else out
        return {**op, "type": "ok", "value": new_v}

    # -- bank ----------------------------------------------------------

    def _bank(self, op):
        c, d = self.conn, self.dialect
        if op["f"] == "read":
            c.query(d.begin())
            try:
                rows = _rows(c.query(
                    "SELECT id, balance FROM accounts"))
                c.query(d.commit())
            except DBError:
                self._try_rollback()
                raise
            return {**op, "type": "ok",
                    "value": {int(r[0]): int(r[1]) for r in rows}}
        if op["f"] == "transfer":
            t = op["value"]
            frm, to, amt = int(t["from"]), int(t["to"]), int(t["amount"])
            c.query(d.begin())
            try:
                rows = _rows(c.query(
                    f"SELECT balance FROM accounts WHERE id = {frm}"
                    f"{self._lock()}"))
                bal = int(rows[0][0]) if rows else 0
                if bal < amt:
                    c.query(d.rollback())
                    return {**op, "type": "fail", "error": "insufficient"}
                if self.sql_opts.get("update_in_place", True):
                    # server-side arithmetic (tidb's update-in-place)
                    c.query(f"UPDATE accounts SET balance = "
                            f"balance - {amt} WHERE id = {frm}")
                    c.query(f"UPDATE accounts SET balance = "
                            f"balance + {amt} WHERE id = {to}")
                else:
                    # client-computed writes: read both, write both —
                    # the lost-update-prone shape the sweep contrasts
                    rows2 = _rows(c.query(
                        f"SELECT balance FROM accounts WHERE id = {to}"
                        f"{self._lock()}"))
                    bal2 = int(rows2[0][0]) if rows2 else 0
                    c.query(f"UPDATE accounts SET balance = {bal - amt} "
                            f"WHERE id = {frm}")
                    c.query(f"UPDATE accounts SET balance = "
                            f"{bal2 + amt} WHERE id = {to}")
                c.query(d.commit())
            except DBError:
                self._try_rollback()
                raise
            return {**op, "type": "ok"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    # -- set -----------------------------------------------------------

    def _set(self, op):
        c = self.conn
        if op["f"] == "add":
            c.query(f"INSERT INTO sets (val) VALUES ({int(op['value'])})")
            return {**op, "type": "ok"}
        if op["f"] == "read":
            rows = _rows(c.query("SELECT val FROM sets"))
            return {**op, "type": "ok",
                    "value": sorted(int(r[0]) for r in rows)}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    # -- dirty-reads ---------------------------------------------------

    def _dirty_rows(self) -> int:
        return int(self.sql_opts.get("dirty_rows", 8))

    def _dirty_reads(self, op):
        """galera/percona dirty_reads.clj:48-66: read = full-table scan
        in one serializable txn; write = read every row then set every
        row to the op's unique value, in shuffled order, so competing
        writers deadlock/cert-fail often. `abort_prob` adds deliberate
        rollbacks so a healthy cluster still produces the failed-txn
        values the checker hunts for."""
        c, d = self.conn, self.dialect
        for stmt in d.begin_serializable():
            c.query(stmt)
        try:
            if op["f"] == "read":
                rows = _rows(c.query("SELECT x FROM dirty"))
                c.query(d.commit())
                return {**op, "type": "ok",
                        "value": [int(r[0]) for r in rows]}
            if op["f"] == "write":
                x = int(op["value"])
                order = random.sample(range(self._dirty_rows()),
                                      self._dirty_rows())
                for i in order:
                    c.query(f"SELECT x FROM dirty WHERE id = {i}")
                for i in order:
                    c.query(f"UPDATE dirty SET x = {x} WHERE id = {i}")
                if (random.random()
                        < float(self.sql_opts.get("abort_prob", 0.0))):
                    c.query(d.rollback())
                    return {**op, "type": "fail",
                            "error": "deliberate-abort"}
                c.query(d.commit())
                return {**op, "type": "ok"}
            c.query(d.rollback())
            return {**op, "type": "fail",
                    "error": f"unknown f {op['f']!r}"}
        except DBError:
            self._try_rollback()
            raise

    # -- table (DDL visibility) ----------------------------------------

    #: "relation/table does not exist": mysql 1146 (SQLSTATE 42S02),
    #: pg 42P01 — the anomaly signal for the table workload.
    NO_TABLE_SQL = {"1146", "42S02", "42P01"}
    #: duplicate primary key: mysql 1062 (23000), pg 23505 — expected
    #: noise (every insert targets id 0), not an anomaly.
    DUP_KEY_SQL = {"1062", "23000", "23505"}

    def _table(self, op):
        """tidb/table.clj:23-47: create-table then insert; an insert
        bounced with 'table doesn't exist' AFTER the create was acked
        is the DDL-visibility anomaly the checker hunts."""
        c = self.conn
        if op["f"] == "create-table":
            t = int(op["value"])
            c.query(f"CREATE TABLE IF NOT EXISTS t{t}"
                    " (id BIGINT PRIMARY KEY, val BIGINT)")
            return {**op, "type": "ok"}
        if op["f"] == "insert":
            t, k = op["value"]
            try:
                c.query(f"INSERT INTO t{int(t)} (id) VALUES ({int(k)})")
            except DBError as e:
                code = str(e.code)
                if code in self.NO_TABLE_SQL:
                    return {**op, "type": "fail", "error": "doesnt-exist"}
                if code in self.DUP_KEY_SQL:
                    return {**op, "type": "fail", "error": "duplicate-key"}
                raise
            return {**op, "type": "ok"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    # -- comments (strict-serializability visibility) ------------------

    def _comments(self, op):
        """comments.clj:60-81: write = blind insert of a unique id
        into the table its id hashes to; read = one txn scanning every
        table for the key, returning the sorted visible ids."""
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        c, d = self.conn, self.dialect
        if op["f"] == "write":
            id_ = int(val)
            c.query(f"INSERT INTO comment_{id_ % TABLE_COUNT} "
                    f"(id, k) VALUES ({id_}, {int(k)})")
            return {**op, "type": "ok"}
        if op["f"] == "read":
            c.query(d.begin())
            try:
                ids = []
                for i in range(TABLE_COUNT):
                    rows = _rows(c.query(
                        f"SELECT id FROM comment_{i} "
                        f"WHERE k = {int(k)}"))
                    ids += [int(r[0]) for r in rows]
                c.query(d.commit())
            except DBError:
                self._try_rollback()
                raise
            return {**op, "type": "ok", "value": lift(sorted(ids))}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    # -- monotonic -----------------------------------------------------

    def _monotonic(self, op):
        c, d = self.conn, self.dialect
        if op["f"] == "read":
            rows = _rows(c.query("SELECT val FROM counter WHERE id = 0"))
            v = int(rows[0][0]) if rows and rows[0][0] is not None else None
            return {**op, "type": "ok", "value": v}
        if op["f"] == "inc":
            c.query(d.begin())
            try:
                rows = _rows(c.query(
                    "SELECT val FROM counter WHERE id = 0"))
                cur = int(rows[0][0]) if rows and rows[0][0] is not None \
                    else 0
                c.query(d.upsert("counter", 0, "val", str(cur + 1)))
                c.query(d.commit())
            except DBError:
                self._try_rollback()
                raise
            return {**op, "type": "ok", "value": cur + 1}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    # -- causal-reverse / sequential ----------------------------------

    def _causal_reverse(self, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        c = self.conn
        if op["f"] == "write":
            c.query(f"INSERT INTO cr (k, v) VALUES ({int(k)}, {int(val)})")
            return {**op, "type": "ok"}
        if op["f"] == "read":
            rows = _rows(c.query(f"SELECT v FROM cr WHERE k = {int(k)}"))
            out = sorted(int(r[0]) for r in rows)
            return {**op, "type": "ok", "value": independent.tuple_(k, out)
                    if independent.is_tuple(v) else out}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    # -- adya g2 -------------------------------------------------------

    def _g2(self, op):
        v = op["value"]
        k, pair = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        a_id, b_id = pair
        c, d = self.conn, self.dialect
        c.query(d.begin())
        try:
            ra = _rows(c.query(f"SELECT id FROM g2a WHERE k = {int(k)}"))
            rb = _rows(c.query(f"SELECT id FROM g2b WHERE k = {int(k)}"))
            if ra or rb:
                c.query(d.rollback())
                return {**op, "type": "fail", "error": "already-present"}
            if a_id is not None:
                c.query(f"INSERT INTO g2a (id, k) "
                        f"VALUES ({int(a_id)}, {int(k)})")
            else:
                c.query(f"INSERT INTO g2b (id, k) "
                        f"VALUES ({int(b_id)}, {int(k)})")
            c.query(d.commit())
        except DBError:
            self._try_rollback()
            raise
        return {**op, "type": "ok"}

    def _try_rollback(self):
        try:
            if self.conn is not None:
                self.conn.query(self.dialect.rollback())
        except (DBError, DriverError, OSError):
            self.close(None)


#: workload name -> SQLClient mode
MODES = {
    "register": "register", "append": "append", "wr": "wr",
    "bank": "bank", "set": "set", "monotonic": "monotonic",
    "sequential": "sequential", "long-fork": "wr", "g2": "g2",
    "dirty-reads": "dirty-reads", "table": "table",
    "comments": "comments",
}


def client_for(dialect: Dialect, workload: str, opts: dict | None = None
               ) -> SQLClient:
    opts = opts or {}
    return SQLClient(dialect, MODES.get(workload, "register"),
                     accounts=opts.get("accounts"),
                     total=opts.get("total-amount", 100),
                     sql_opts=opts.get("sql-opts"))

"""YCQL client: yugabyte's Cassandra-compatible API over drivers.cql.

Counterpart of the reference's YCQL client namespaces
(yugabyte/src/yugabyte/ycql/*, dual-API matrix at
yugabyte/src/yugabyte/core.clj:74-110). CQL semantics differ from SQL in
ways the workloads exploit:

  * INSERT is an upsert (no duplicate-key errors) -> set-adds dedupe,
  * CAS is a lightweight transaction: `UPDATE .. IF val = old`, whose
    result row is `[applied]` (+ current values when not applied),
  * multi-row atomicity is `BEGIN TRANSACTION .. END TRANSACTION;`
    blocks (writes only — reads can't join, so the bank transfer reads
    first, then writes computed balances in a txn block, exactly the
    reference's lost-update-prone shape the checker exists to catch),
  * lists are native: `val = val + [x]` appends.

The port's copy of `jepsen_tpu/suites/ycql.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import client as jclient
from .. import independent
from ..drivers import DBError, DriverError
from .sql import resolve

KEYSPACE = "jepsen"

DDL = [
    f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE}",
    f"USE {KEYSPACE}",
    "CREATE TABLE IF NOT EXISTS registers (id bigint PRIMARY KEY,"
    " val bigint) WITH transactions = {'enabled': true}",
    "CREATE TABLE IF NOT EXISTS lists (id bigint PRIMARY KEY,"
    " val list<bigint>) WITH transactions = {'enabled': true}",
    "CREATE TABLE IF NOT EXISTS accounts (id bigint PRIMARY KEY,"
    " balance bigint) WITH transactions = {'enabled': true}",
    "CREATE TABLE IF NOT EXISTS sets (val bigint PRIMARY KEY)",
    "CREATE TABLE IF NOT EXISTS counter (id bigint PRIMARY KEY,"
    " val bigint) WITH transactions = {'enabled': true}",
]


class YCQLClient(jclient.Client):
    def __init__(self, mode: str = "register", port: int = 9042,
                 accounts: list | None = None, total: int = 100,
                 node: str | None = None, timeout: float = 10.0):
        self.mode = mode
        self.port = port
        self.accounts = accounts if accounts is not None else list(range(8))
        self.total = total
        self.node = node
        self.timeout = timeout
        self.conn = None
        self._setup_done = False

    def open(self, test, node):
        return YCQLClient(self.mode, self.port, self.accounts,
                          self.total, node, self.timeout)

    def _ensure_conn(self, test):
        if self.conn is None:
            from ..drivers import cql
            host, port = resolve(self.node, self.port, test or {})
            self.conn = cql.connect(host, port, timeout=self.timeout)
        if not self._setup_done:
            for stmt in DDL:
                self.conn.query(stmt)
            if self.mode == "bank":
                # INSERT IF NOT EXISTS: atomic seed (LWT)
                self.conn.query(
                    f"INSERT INTO accounts (id, balance) VALUES "
                    f"(0, {self.total}) IF NOT EXISTS")
                for a in self.accounts:
                    if a != 0:
                        self.conn.query(
                            f"INSERT INTO accounts (id, balance) VALUES "
                            f"({int(a)}, 0) IF NOT EXISTS")
            self._setup_done = True

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    #: CQL error codes whose outcome is UNKNOWN for a write: the
    #: coordinator lost track, but replicas may still apply it.
    #: 0x1100 WriteTimeout, 0x1400 WriteFailure, 0x0000 ServerError.
    AMBIGUOUS = {"cql-0x1100", "cql-0x1400", "cql-0x0000"}

    def invoke(self, test, op):
        read_only = op.get("f") == "read"
        try:
            self._ensure_conn(test)
            return self._dispatch(op)
        except DBError as e:
            ambiguous = str(e.code) in self.AMBIGUOUS and not read_only
            return {**op, "type": "info" if ambiguous else "fail",
                    "error": f"ycql-{e.code}: {e.message[:120]}"}
        except (DriverError, OSError) as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}

    def _dispatch(self, op):
        if self.mode == "bank":
            return self._bank(op)
        if self.mode == "set":
            return self._set(op)
        if self.mode == "monotonic":
            return self._monotonic(op)
        if self.mode == "long-fork":
            return self._long_fork(op)
        return self._register(op)

    def _register(self, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        c = self.conn
        if op["f"] == "read":
            rows = c.query(f"SELECT val FROM registers "
                           f"WHERE id = {int(k)}").rows
            out = rows[0][0] if rows else None
            return {**op, "type": "ok", "value": lift(out)}
        if op["f"] == "write":
            c.query(f"INSERT INTO registers (id, val) VALUES "
                    f"({int(k)}, {int(val)})")
            return {**op, "type": "ok"}
        if op["f"] == "cas":
            old, new = val
            res = c.query(f"UPDATE registers SET val = {int(new)} "
                          f"WHERE id = {int(k)} IF val = {int(old)}")
            applied = bool(res.rows and res.rows[0][0])
            if applied:
                return {**op, "type": "ok"}
            return {**op, "type": "fail", "error": "precondition"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _long_fork(self, op):
        """Long-fork over key registers: the whole-group read is ONE
        `IN`-clause SELECT (a single-statement snapshot read on a
        transactional table — the reference's approach,
        yugabyte/src/yugabyte/ycql/long_fork.clj:33-44); writes are
        single-row inserts. Read-write-mixed txns stay unsupported
        (reads can't join YCQL txn blocks), which is why append/wr are
        out of the YCQL matrix."""
        mops = op["value"]
        k0 = None
        if independent.is_tuple(mops):
            k0, mops = mops.key, mops.value
        c = self.conn
        if all(m[0] == "r" for m in mops):
            ks = sorted({int(m[1]) for m in mops})
            rows = c.query(
                f"SELECT id, val FROM registers WHERE id IN "
                f"({', '.join(str(k) for k in ks)})").rows
            got = {int(r[0]): (int(r[1]) if r[1] is not None else None)
                   for r in rows}
            out = [["r", mk, got.get(int(mk))] for _mf, mk, _mv in mops]
        elif len(mops) == 1 and mops[0][0] == "w":
            _, k, v = mops[0]
            c.query(f"INSERT INTO registers (id, val) VALUES "
                    f"({int(k)}, {int(v)})")
            out = [["w", k, v]]
        else:
            return {**op, "type": "fail",
                    "error": "ycql long-fork: mixed txn unsupported"}
        new_v = independent.tuple_(k0, out) if k0 is not None else out
        return {**op, "type": "ok", "value": new_v}

    def _bank(self, op):
        c = self.conn
        if op["f"] == "read":
            rows = c.query("SELECT id, balance FROM accounts").rows
            return {**op, "type": "ok",
                    "value": {int(r[0]): int(r[1]) for r in rows}}
        if op["f"] == "transfer":
            t = op["value"]
            frm, to, amt = int(t["from"]), int(t["to"]), int(t["amount"])
            # Server-side arithmetic inside the txn block — the
            # reference's shape (ycql/bank.clj:46-58). No balance
            # check, so overdrafts happen; the suite runs this workload
            # with negative balances allowed.
            c.query("BEGIN TRANSACTION "
                    f"UPDATE accounts SET balance = balance - {amt} "
                    f"WHERE id = {frm}; "
                    f"UPDATE accounts SET balance = balance + {amt} "
                    f"WHERE id = {to}; "
                    "END TRANSACTION;")
            return {**op, "type": "ok"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _set(self, op):
        c = self.conn
        if op["f"] == "add":
            c.query(f"INSERT INTO sets (val) VALUES ({int(op['value'])})")
            return {**op, "type": "ok"}
        if op["f"] == "read":
            rows = c.query("SELECT val FROM sets").rows
            return {**op, "type": "ok",
                    "value": sorted(int(r[0]) for r in rows)}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _monotonic(self, op):
        c = self.conn
        if op["f"] == "read":
            rows = c.query("SELECT val FROM counter WHERE id = 0").rows
            v = int(rows[0][0]) if rows and rows[0][0] is not None else None
            return {**op, "type": "ok", "value": v}
        if op["f"] == "inc":
            # LWT loop: CAS val -> val+1 (the reference's counter
            # workload shape)
            for _ in range(16):
                rows = c.query("SELECT val FROM counter "
                               "WHERE id = 0").rows
                cur = int(rows[0][0]) if rows and rows[0][0] is not None \
                    else None
                if cur is None:
                    res = c.query("INSERT INTO counter (id, val) VALUES "
                                  "(0, 1) IF NOT EXISTS")
                else:
                    res = c.query(f"UPDATE counter SET val = {cur + 1} "
                                  f"WHERE id = 0 IF val = {cur}")
                if bool(res.rows and res.rows[0][0]):
                    return {**op, "type": "ok",
                            "value": 1 if cur is None else cur + 1}
            return {**op, "type": "fail", "error": "cas-exhausted"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}


#: workload -> YCQL mode (the reference's YCQL matrix: bank, counter,
#: long-fork, set, single/multi-key-acid — no append/wr, whose
#: read-write txns can't be expressed in YCQL txn blocks)
MODES = {"register": "register", "set": "set", "bank": "bank",
         "monotonic": "monotonic", "long-fork": "long-fork"}


def client_for(workload: str, opts: dict | None = None) -> YCQLClient:
    opts = opts or {}
    if workload not in MODES:
        raise ValueError(
            f"workload {workload!r} has no YCQL client (reads can't "
            f"join YCQL txn blocks); supported: {sorted(MODES)}")
    return YCQLClient(MODES[workload],
                      accounts=opts.get("accounts"),
                      total=opts.get("total-amount", 100))

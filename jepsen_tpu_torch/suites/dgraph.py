"""Dgraph suite — part of config #5.

Counterpart of dgraph/src/jepsen/dgraph (SURVEY.md §2.6): zero + alpha
daemons and a matrix of bank, long-fork, linearizable-register,
sequential, set, and upsert (predicate uniqueness ≈ the adya G2
workload). Clients speak Dgraph's HTTP API when driven live; the
workload/checker matrix and analyze path are complete without a live
cluster.

The port's copy of `jepsen_tpu/suites/dgraph.py`; it imports the
standard library and the port's own modules only.
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
from ..drivers import DBError, DriverError
from . import base_opts, standard_workloads, suite_test
from .sql import resolve

VERSION = "v1.0.17"
DIR = "/opt/dgraph"


class DgraphDB(jdb.DB, jdb.SignalProcess, jdb.LogFiles):
    """dgraph zero + alpha daemons (dgraph/src/jepsen/dgraph/support.clj);
    whole-node kill/pause via SignalProcess."""

    process_pattern = f"{DIR}/dgraph"

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://github.com/dgraph-io/dgraph/releases/download/"
               f"{self.version}/dgraph-linux-amd64.tar.gz")
        cutil.install_archive(sess, url, DIR)
        self._start(sess, test, node)

    def _start(self, sess, test, node):
        nodes = test.get("nodes", [])
        zero = nodes[0] if nodes else node
        if node == zero:
            cutil.start_daemon(
                sess, f"{DIR}/dgraph", "zero",
                "--my", f"{node}:5080",
                "--wal", f"{DIR}/zw",
                logfile=f"{DIR}/zero.log", pidfile=f"{DIR}/zero.pid",
                chdir=DIR)
        cutil.start_daemon(
            sess, f"{DIR}/dgraph", "alpha",
            "--my", f"{node}:7080",
            "--zero", f"{zero}:5080",
            "--postings", f"{DIR}/p", "--wal", f"{DIR}/w",
            logfile=f"{DIR}/alpha.log", pidfile=f"{DIR}/alpha.pid",
            chdir=DIR)

    def teardown(self, test, node):
        sess = control.current_session().su()
        for pid in ("alpha.pid", "zero.pid"):
            cutil.stop_daemon(sess, f"{DIR}/{pid}")
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [f"{DIR}/zero.log", f"{DIR}/alpha.log"]


SCHEMA = """
key: int @index(int) .
val: int .
acct: int @index(int) .
balance: int .
el: int @index(int) .
skey: int @index(int) .
sval: int .
gkey: int @index(int) .
gside: string .
dkey: int @index(int) @upsert .
"""


class DgraphClient(jclient.Client):
    """Ops over Dgraph's HTTP transaction API (the reference uses the
    grpc client, dgraph/src/jepsen/dgraph/client.clj — same start_ts /
    commit dance, same conflict-aborts-map-to-fail semantics)."""

    def __init__(self, mode: str = "register", port: int = 8080,
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
        return DgraphClient(self.mode, self.port, self.accounts,
                            self.total, node, self.timeout)

    def _ensure_conn(self, test):
        if self.conn is None:
            from ..drivers import dgraph_http
            host, port = resolve(self.node, self.port, test or {})
            self.conn = dgraph_http.connect(host, port, self.timeout)
        if not self._setup_done:
            self.conn.alter(SCHEMA)
            if self.mode == "bank":
                # conditional-upsert seed: insert only missing accounts
                for a in self.accounts:
                    bal = self.total if a == 0 else 0
                    self.conn.mutate(
                        query=f"{{ u as var(func: eq(acct, {int(a)})) }}",
                        cond="@if(eq(len(u), 0))",
                        set_obj=[{"uid": "_:new", "acct": int(a),
                                  "balance": bal}])
            self._setup_done = True

    def close(self, test):
        self.conn = None

    def invoke(self, test, op):
        read_only = op.get("f") == "read"
        try:
            self._ensure_conn(test)
            return self._dispatch(op)
        except DBError as e:
            # Definite failures: txn aborts (conflict) and 4xx
            # rejections. 5xx means the server may or may not have
            # applied the op — indeterminate for writes
            # (dgraph/client.clj's with-conflict-as-fail distinction).
            code = str(e.code)
            definite = (code == "ErrorAborted" or code.startswith("4")
                        or read_only)
            return {**op, "type": "fail" if definite else "info",
                    "error": f"dgraph-{e.code}: {e.message[:120]}"}
        except (DriverError, OSError) as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}

    def _dispatch(self, op):
        if self.mode == "bank":
            return self._bank(op)
        if self.mode == "delete":
            return self._delete_ops(op)
        if self.mode == "set":
            return self._set(op)
        if self.mode in ("sequential", "causal-reverse"):
            return self._sequential(op)
        if self.mode == "wr":
            return self._wr_txn(op)
        if op.get("f") == "insert":
            return self._upsert_g2(op)
        return self._register(op)

    def _wr_txn(self, op):
        """[f k v] micro-op txns over key registers, one dgraph txn
        (long-fork / rw-register shapes)."""
        mops = op["value"]
        k0 = None
        if independent.is_tuple(mops):
            k0, mops = mops.key, mops.value
        txn = self.conn.begin()
        out_mops = []
        for mf, mk, mv in mops:
            if mf == "w":
                res = txn.query(
                    f"{{ q(func: eq(key, {int(mk)})) {{ uid }} }}")
                nodes = res.get("data", {}).get("q") or []
                uid = nodes[0]["uid"] if nodes else "_:new"
                txn.mutate(set_obj=[{"uid": uid, "key": int(mk),
                                     "val": int(mv)}])
                out_mops.append([mf, mk, mv])
            else:
                res = txn.query(
                    f"{{ q(func: eq(key, {int(mk)})) {{ val }} }}")
                vals = self._q_vals(res, "q", "val")
                out_mops.append([mf, mk,
                                 int(vals[0]) if vals else None])
        txn.commit()
        new_v = independent.tuple_(k0, out_mops) if k0 is not None \
            else out_mops
        return {**op, "type": "ok", "value": new_v}

    def _q_vals(self, out: dict, q: str, pred: str) -> list:
        return [n[pred] for n in (out.get("data", {}).get(q) or [])
                if pred in n]

    def _register(self, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        c = self.conn
        if op["f"] == "read":
            out = c.query(f"{{ q(func: eq(key, {int(k)})) {{ val }} }}")
            vals = self._q_vals(out, "q", "val")
            return {**op, "type": "ok",
                    "value": lift(int(vals[0]) if vals else None)}
        if op["f"] == "write":
            # conditional upsert: update the node when it exists, create
            # it when it doesn't — a bare uid(u) set with empty u is a
            # silent no-op in dgraph.
            c.mutate(
                query=f"{{ u as var(func: eq(key, {int(k)})) }}",
                mutations=[
                    {"cond": "@if(gt(len(u), 0))",
                     "set": [{"uid": "uid(u)", "key": int(k),
                              "val": int(val)}]},
                    {"cond": "@if(eq(len(u), 0))",
                     "set": [{"uid": "_:new", "key": int(k),
                              "val": int(val)}]},
                ])
            return {**op, "type": "ok"}
        if op["f"] == "cas":
            old, new = val
            txn = c.begin()
            out = txn.query(
                f"{{ q(func: eq(key, {int(k)})) {{ uid val }} }}")
            nodes = out.get("data", {}).get("q") or []
            cur = int(nodes[0]["val"]) if nodes and "val" in nodes[0] \
                else None
            if cur != old:
                txn.discard()
                return {**op, "type": "fail", "error": "precondition"}
            txn.mutate(set_obj=[{"uid": nodes[0]["uid"],
                                 "key": int(k), "val": int(new)}])
            txn.commit()  # conflict -> DBError -> fail
            return {**op, "type": "ok"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _bank(self, op):
        c = self.conn
        if op["f"] == "read":
            out = c.query("{ q(func: has(acct)) { acct balance } }")
            nodes = out.get("data", {}).get("q") or []
            return {**op, "type": "ok",
                    "value": {int(n["acct"]): int(n["balance"])
                              for n in nodes}}
        if op["f"] == "transfer":
            t = op["value"]
            frm, to, amt = int(t["from"]), int(t["to"]), int(t["amount"])
            txn = c.begin()
            out = txn.query(
                f"{{ a(func: eq(acct, {frm})) {{ uid balance }} "
                f"b(func: eq(acct, {to})) {{ uid balance }} }}")
            a = (out.get("data", {}).get("a") or [None])[0]
            b = (out.get("data", {}).get("b") or [None])[0]
            if not a or not b or int(a["balance"]) < amt:
                txn.discard()
                return {**op, "type": "fail", "error": "insufficient"}
            txn.mutate(set_obj=[
                {"uid": a["uid"], "balance": int(a["balance"]) - amt},
                {"uid": b["uid"], "balance": int(b["balance"]) + amt}])
            txn.commit()
            return {**op, "type": "ok"}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _set(self, op):
        c = self.conn
        if op["f"] == "add":
            c.mutate(set_obj=[{"el": int(op["value"])}])
            return {**op, "type": "ok"}
        if op["f"] == "read":
            out = c.query("{ q(func: has(el)) { el } }")
            return {**op, "type": "ok",
                    "value": sorted(int(v) for v in
                                    self._q_vals(out, "q", "el"))}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _sequential(self, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        c = self.conn
        if op["f"] == "write":
            c.mutate(set_obj=[{"skey": int(k), "sval": int(val)}])
            return {**op, "type": "ok"}
        if op["f"] == "read":
            out = c.query(
                f"{{ q(func: eq(skey, {int(k)})) {{ sval }} }}")
            vals = sorted(int(x) for x in self._q_vals(out, "q", "sval"))
            return {**op, "type": "ok",
                    "value": independent.tuple_(k, vals)
                    if independent.is_tuple(v) else vals}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _delete_ops(self, op):
        """delete.clj:32-60: per-key upsert/delete/read against an
        indexed predicate; reads must see the index agree with the data
        (zero records, or exactly one {uid, key} record)."""
        v = op["value"]
        k = v.key if independent.is_tuple(v) else 0
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        c = self.conn
        if op["f"] == "read":
            out = c.query(
                f"{{ q(func: eq(dkey, {int(k)})) {{ uid dkey }} }}")
            nodes = out.get("data", {}).get("q") or []
            recs = [{"uid": n.get("uid"), "key": n.get("dkey")}
                    for n in nodes]
            return {**op, "type": "ok", "value": lift(recs)}
        if op["f"] == "upsert":
            txn = c.begin()
            out = txn.query(
                f"{{ q(func: eq(dkey, {int(k)})) {{ uid }} }}")
            if out.get("data", {}).get("q"):
                txn.discard()
                return {**op, "type": "fail", "error": "present"}
            txn.mutate(set_obj=[{"uid": "_:new", "dkey": int(k)}])
            txn.commit()  # conflict -> DBError ErrorAborted -> fail
            return {**op, "type": "ok"}
        if op["f"] == "delete":
            txn = c.begin()
            out = txn.query(
                f"{{ q(func: eq(dkey, {int(k)})) {{ uid }} }}")
            nodes = out.get("data", {}).get("q") or []
            if not nodes:
                txn.discard()
                return {**op, "type": "fail", "error": "not-found"}
            txn.mutate(delete_obj=[{"uid": nodes[0]["uid"]}])
            txn.commit()
            return {**op, "type": "ok", "uid": nodes[0]["uid"]}
        return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}

    def _upsert_g2(self, op):
        v = op["value"]
        k, pair = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        a_id, b_id = pair
        side = "a" if a_id is not None else "b"
        txn = self.conn.begin()
        out = txn.query(
            f"{{ q(func: eq(gkey, {int(k)})) {{ uid }} }}")
        if out.get("data", {}).get("q"):
            txn.discard()
            return {**op, "type": "fail", "error": "already-present"}
        txn.mutate(set_obj=[{"gkey": int(k), "gside": side}])
        txn.commit()  # write-write conflict on gkey -> abort -> fail
        return {**op, "type": "ok"}


class DeleteChecker(jchecker.Checker):
    """delete.clj:66-90: every ok read finds either nothing, or exactly
    one record carrying both a uid and the key under test — anything
    else (ghost records, index/data divergence, half-deleted nodes) is
    a bad read."""

    def check(self, test, history, opts):
        k = (opts or {}).get("history-key")
        bad = []
        for op in history:
            if op.get("type") != "ok" or op.get("f") != "read":
                continue
            recs = op.get("value")
            if not isinstance(recs, (list, tuple)):
                bad.append(op)
                continue
            if len(recs) == 0:
                continue
            r0 = recs[0] if isinstance(recs[0], dict) else {}
            if (len(recs) == 1 and set(r0) == {"uid", "key"}
                    and r0["uid"] and (k is None or r0["key"] == k)):
                continue
            bad.append(op)
        return {"valid?": not bad, "bad-reads": bad[:16],
                "bad-count": len(bad)}


def delete_workload(opts: dict) -> dict:
    """delete.clj:92-104: independent per-key concurrent generator over
    a mix of read/upsert/delete, checked per key."""
    nodes = opts.get("nodes") or ["n1", "n2", "n3", "n4", "n5"]

    def r(test=None, ctx=None):
        return {"type": "invoke", "f": "read", "value": None}

    def u(test=None, ctx=None):
        return {"type": "invoke", "f": "upsert", "value": None}

    def d(test=None, ctx=None):
        return {"type": "invoke", "f": "delete", "value": None}

    return {
        "generator": independent.concurrent_generator(
            2 * len(nodes), range(10_000),
            lambda k: gen.stagger(
                0.01, gen.limit(1000, gen.mix([r, u, d])))),
        "checker": independent.checker(jchecker.compose({
            "deletes": DeleteChecker()})),
    }


#: workload -> client mode
MODES = {"register": "register", "bank": "bank", "set": "set",
         "sequential": "sequential", "upsert": "g2", "long-fork": "wr",
         "delete": "delete"}


def default_client(workload: str, opts: dict) -> DgraphClient:
    return DgraphClient(MODES.get(workload, "register"),
                        accounts=opts.get("accounts"),
                        total=opts.get("total-amount", 100))


def workloads(opts: dict | None = None) -> dict:
    std = standard_workloads(opts)
    return {
        "bank": std["bank"],
        "long-fork": std["long-fork"],
        "register": std["register"],      # linearizable-register
        "sequential": std["sequential"],
        "set": std["set"],
        "upsert": std["g2"],              # predicate-uniqueness races
        "delete": lambda: delete_workload(opts or {}),
    }


def dgraph_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "bank")
    return suite_test(
        "dgraph", wname, opts, workloads(opts),
        db=DgraphDB(opts.get("version", VERSION)),
        client=opts.get("client") or default_client(wname, opts),
        nemesis=jnemesis.partition_random_halves(),
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: dgraph_test(
            {**tmap, "workload": resolve_workload(args, tmap, "bank")}),
        name="dgraph",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        tests_fn=lambda tmap, args: [
            dgraph_test({**tmap, "workload": w})
            for w in ([args.workload] if getattr(
                args, "workload", None) else sorted(workloads()))],
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

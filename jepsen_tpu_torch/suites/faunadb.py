"""FaunaDB suite.

Counterpart of faunadb/src/jepsen/faunadb/ (3,605 LoC, the largest
remaining reference suite): deb-installed FaunaDB with a
log-replicated cluster, driven over its HTTP+JSON query API with
secret-key auth (the reference's JVM driver is the same HTTP endpoint,
client.clj:36-60). FaunaClient speaks the FQL wire-JSON protocol via
drivers.fauna_http and maps the register (register.clj:31-62), set
(set.clj:35-60), bank (bank.clj:80-140), monotonic, g2, pages
(pages.clj — pagination isolation of grouped inserts) and
multimonotonic (multimonotonic.clj — increment-only registers with
timestamp-order and read-skew checkers) families; pass ``client`` to
substitute your own. opts {"nemesis": "topology"} swaps the partition
nemesis for the cluster-membership TopologyNemesis (topology.clj).

The port's copy of `jepsen_tpu/suites/faunadb.py`; it imports the
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
from ..drivers import DBError, DriverError
from . import base_opts, standard_workloads, suite_test

LOGFILE = "/var/log/faunadb/core.log"


class FaunaDB(jdb.DB, jdb.LogFiles):
    """deb install + faunadb.yml with the replica topology
    (faunadb/src/jepsen/faunadb/auto.clj's install!/configure!)."""

    def __init__(self, version: str = "2.5.5"):
        self.version = version

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("sh", "-c",
                  "wget -qO- https://repo.fauna.com/faunadb-gpg-public"
                  ".key | apt-key add -")
        sess.exec("sh", "-c",
                  'echo "deb [arch=amd64] https://repo.fauna.com/debian'
                  ' stable non-free" > /etc/apt/sources.list.d/'
                  'faunadb.list')
        sess.exec("apt-get", "update")
        sess.exec("apt-get", "install", "-y",
                  f"faunadb={self.version}")
        nodes = test.get("nodes", [node])
        cfg = "\n".join([
            "auth_root_key: secret",
            f"network_broadcast_address: {node}",
            f"network_host_id: {node}",
            "network_listen_address: 0.0.0.0",
            "storage_data_path: /var/lib/faunadb",
            "log_path: /var/log/faunadb",
        ])
        sess.exec("sh", "-c",
                  f"cat > /etc/faunadb.yml << 'EOF'\n{cfg}\nEOF")
        sess.exec("service", "faunadb", "restart")
        if node == nodes[0]:
            sess.exec_ok("faunadb-admin", "init")
        else:
            sess.exec_ok("faunadb-admin", "join", nodes[0])

    def teardown(self, test, node):
        sess = control.current_session().su()
        sess.exec_ok("service", "faunadb", "stop")
        sess.exec("rm", "-rf", "/var/lib/faunadb")

    def log_files(self, test, node):
        return [LOGFILE]


class FaunaClient(jclient.Client):
    """Workload ops over the FQL wire protocol (drivers.fauna_http).

    Each mode mirrors its reference client: register
    (register.clj:31-62, CAS via Let/Select/If over data.register),
    set (set.clj:35-60, class + all-elements index, reads paginate the
    index), bank (bank.clj:80-140, transfer aborts when the balance
    would go negative), monotonic (counter via Add), g2
    (g2.clj, predicate emptiness check then insert)."""

    PORT = 8443

    def __init__(self, mode: str = "register", accounts: list | None = None,
                 total: int = 100, node: str | None = None,
                 timeout: float = 10.0, naive_reads: bool = False):
        self.mode = mode
        self.accounts = accounts if accounts is not None else list(range(8))
        self.total = total
        self.node = node
        self.timeout = timeout
        self.naive_reads = naive_reads  # pages: per-page transactions
        self.conn = None
        self._setup_done = False

    def open(self, test, node):
        return FaunaClient(self.mode, self.accounts, self.total, node,
                           self.timeout, self.naive_reads)

    def _ensure_conn(self, test):
        from ..drivers import fauna_http as q
        from .sql import resolve
        if self.conn is None:
            host, port = resolve(self.node, self.PORT, test or {})
            # register/set read through /linearized like the reference
            self.conn = q.connect(
                host, port, linearized=self.mode in ("register", "set"),
                timeout=self.timeout)
        if not self._setup_done:
            self._setup(q)
            self._setup_done = True

    def _upsert_class(self, q, name: str):
        self.conn.query(q.if_(q.exists(q.class_(name)), None,
                              q.create_class({"name": name})))

    def _setup(self, q):
        if self.mode in ("register", "monotonic"):
            self._upsert_class(q, "test")
        elif self.mode == "set":
            self._upsert_class(q, "elements")
            self.conn.query(q.if_(
                q.exists(q.index("all-elements")), None,
                q.create_index({
                    "name": "all-elements",
                    "source": q.class_("elements"),
                    "active": True,
                    "values": [{"field": ["data", "value"]}]})))
        elif self.mode == "bank":
            self._upsert_class(q, "accounts")
            for i, a in enumerate(self.accounts):
                ref = q.ref_(q.class_("accounts"), a)
                bal = self.total if i == 0 else 0
                self.conn.query(q.when(
                    q.not_(q.exists(ref)),
                    q.create(ref, {"data": {"balance": bal}})))
        elif self.mode == "g2":
            for name in ("a", "b"):
                self._upsert_class(q, name)
                self.conn.query(q.if_(
                    q.exists(q.index(f"{name}-by-key")), None,
                    q.create_index({
                        "name": f"{name}-by-key",
                        "source": q.class_(name),
                        "active": True,
                        "terms": [{"field": ["data", "key"]}]})))
        elif self.mode == "pages":
            self._upsert_class(q, "elements")
            self.conn.query(q.if_(
                q.exists(q.index("elements-by-key")), None,
                q.create_index({
                    "name": "elements-by-key",
                    "source": q.class_("elements"),
                    "active": True,
                    "terms": [{"field": ["data", "key"]}],
                    "values": [{"field": ["data", "value"]}]})))
        elif self.mode == "multimonotonic":
            self._upsert_class(q, "registers")
        elif self.mode == "internal":
            self._upsert_class(q, "cats")
            self.conn.query(q.if_(
                q.exists(q.index("cats_by_type")), None,
                q.create_index({
                    "name": "cats_by_type",
                    "source": q.class_("cats"),
                    "active": True,
                    "terms": [{"field": ["data", "type"]}],
                    "values": [{"field": ["ref"]},
                               {"field": ["data", "name"]}]})))

    # -- internal-consistency mode (faunadb/internal.clj) ------------------

    @staticmethod
    def _cats_pairs(q, typ):
        """[[ref, name], ...] for cats of `typ` via the index."""
        return q.select(["data"], q.paginate(
            q.match(q.index("cats_by_type"), typ), size=1024))

    @classmethod
    def _cats_names(cls, q, typ):
        return q.map_(q.lambda_(["r", "name"], q.var("name")),
                      cls._cats_pairs(q, typ))

    @classmethod
    def _delete_by_type(cls, q, typ):
        refs = q.map_(q.lambda_(["r", "name"], q.var("r")),
                      cls._cats_pairs(q, typ))
        return q.foreach(
            q.lambda_("r", q.when(q.exists(q.var("r")),
                                  q.delete(q.var("r")))), refs)

    def _internal_dispatch(self, q, op, f, v):
        """internal.clj:69-133: one txn creates a cat and reads the
        index before/after INSIDE the txn, through three differently-
        shaped queries (let bindings, object literal, array literal) —
        all must observe the txn's own effects identically."""
        create = q.create(q.class_("cats"),
                          {"data": {"type": "tabby", "name": v}})
        match = self._cats_names(q, "tabby")
        if f == "reset":
            self.conn.query(q.do(self._delete_by_type(q, "tabby"),
                                 self._delete_by_type(q, "calico")))
            return {**op, "type": "ok"}
        if f == "create-tabby-let":
            res = self.conn.query(q.let(
                {"t": q.time("now")},
                q.let({"tabbies_0": q.at(q.var("t"), match),
                       "tabby": create,
                       "tabbies_1": q.at(q.var("t"), match)},
                      # reversed key order vs the bindings, like the
                      # reference, so we check let scoping not literals
                      {"tabbies-1": q.var("tabbies_1"),
                       "tabby": q.var("tabby"),
                       "tabbies-0": q.var("tabbies_0")})))
        elif f == "create-tabby-obj":
            r = self.conn.query({"c": match, "a": create, "b": match})
            res = {"tabbies-0": r["c"], "tabby": r["a"],
                   "tabbies-1": r["b"]}
        elif f == "create-tabby-arr":
            r = self.conn.query([match, create, match])
            res = {"tabbies-0": r[0], "tabby": r[1], "tabbies-1": r[2]}
        elif f == "change-type":
            refs1 = q.map_(q.lambda_(["r", "name"], q.var("r")),
                           q.select(["data"], q.paginate(
                               q.match(q.index("cats_by_type"),
                                       "tabby"), size=1)))
            r = self.conn.query([
                q.let({"rs": refs1},
                      q.when(q.not_(q.equals(q.var("rs"), [])),
                             q.update(q.select([0], q.var("rs")),
                                      {"data": {"type": "calico"}}))),
                match, self._cats_names(q, "calico")])
            return {**op, "type": "ok",
                    "value": {"cat": r[0], "tabbies": r[1],
                              "calicos": r[2]}}
        else:
            return {**op, "type": "fail", "error": f"unknown f {f!r}"}
        return {**op, "type": "ok", "value": res}

    def close(self, test):
        self.conn = None

    def invoke(self, test, op):
        read_only = op.get("f") == "read"
        try:
            self._ensure_conn(test)
            return self._dispatch(op)
        except DBError as e:
            return {**op, "type": "fail",
                    "error": f"fauna-{e.code}: {e.message[:120]}"}
        except (DriverError, OSError) as e:
            self.close(test)
            return {**op, "type": "fail" if read_only else "info",
                    "error": str(e)[:160]}

    def _dispatch(self, op):
        from ..drivers import fauna_http as q
        f = op["f"]
        v = op.get("value")
        if self.mode == "register":
            k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
            lift = (lambda x: independent.tuple_(k, x)) \
                if independent.is_tuple(v) else (lambda x: x)
            ref = q.ref_(q.class_("test"), k)
            if f == "read":
                res = self.conn.query(q.if_(q.exists(ref), q.get_(ref)))
                reg = (res or {}).get("data", {}).get("register") \
                    if isinstance(res, dict) else None
                return {**op, "type": "ok", "value": lift(reg)}
            if f == "write":
                self.conn.query(q.if_(
                    q.exists(ref),
                    q.update(ref, {"data": {"register": val}}),
                    q.create(ref, {"data": {"register": val}})))
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = val
                res = self.conn.query(q.if_(
                    q.exists(ref),
                    q.let({"reg": q.select(["data", "register"],
                                           q.get_(ref))},
                          q.if_(q.equals(old, q.var("reg")),
                                q.update(ref,
                                         {"data": {"register": new}}),
                                False)),
                    False))
                return {**op, "type": "ok" if res else "fail"}
        elif self.mode == "set":
            if f == "add":
                self.conn.query(q.create(q.ref_(q.class_("elements"), v),
                                         {"data": {"value": v}}))
                return {**op, "type": "ok"}
            if f == "read":
                vals = self.conn.query_all(q.match(q.index("all-elements")))
                return {**op, "type": "ok", "value": set(vals)}
        elif self.mode == "bank":
            cls = q.class_("accounts")
            if f == "read":
                res = self.conn.query([
                    q.when(q.exists(q.ref_(cls, a)),
                           [a, q.select(["data", "balance"],
                                        q.get_(q.ref_(cls, a)))])
                    for a in self.accounts])
                return {**op, "type": "ok",
                        "value": {p[0]: p[1] for p in res if p}}
            if f == "transfer":
                frm, to, amt = v["from"], v["to"], v["amount"]
                try:
                    self.conn.query(q.let(
                        {"a": q.subtract(
                            q.select(["data", "balance"],
                                     q.get_(q.ref_(cls, frm))), amt)},
                        q.if_(q.lt(q.var("a"), 0),
                              q.abort("balance would go negative"),
                              q.do(
                                  q.update(q.ref_(cls, frm),
                                           {"data": {"balance":
                                                     q.var("a")}}),
                                  q.update(q.ref_(cls, to),
                                           {"data": {"balance": q.add(
                                               q.select(
                                                   ["data", "balance"],
                                                   q.get_(q.ref_(cls,
                                                                 to))),
                                               amt)}})))))
                    return {**op, "type": "ok"}
                except DBError as e:
                    if "would go negative" in e.message:
                        return {**op, "type": "fail", "error": "negative"}
                    raise
        elif self.mode == "monotonic":
            ref = q.ref_(q.class_("test"), 0)
            if f == "read":
                res = self.conn.query(q.if_(
                    q.exists(ref),
                    q.select(["data", "value"], q.get_(ref)), 0))
                return {**op, "type": "ok", "value": res}
            if f == "inc":
                res = self.conn.query(q.if_(
                    q.exists(ref),
                    q.select(["data", "value"], q.update(
                        ref, {"data": {"value": q.add(
                            q.select(["data", "value"], q.get_(ref)),
                            1)}})),
                    q.select(["data", "value"],
                             q.create(ref, {"data": {"value": 1}}))))
                return {**op, "type": "ok", "value": res}
        elif self.mode == "pages":
            # pages.clj:31-66: groups of elements created in ONE txn;
            # concurrent paginated reads of the key's whole index — for
            # every element of a group, the rest must appear too.
            k, val = (v.key, v.value) if independent.is_tuple(v) \
                else (0, v)
            if f == "add":
                self.conn.query(q.do(*[
                    q.create(q.ref_(q.class_("elements"), f"{k}:{e}"),
                             {"data": {"key": k, "value": e}})
                    for e in val]))
                return {**op, "type": "ok"}
            if f == "read":
                q_all = (self.conn.query_all_naive if self.naive_reads
                         else self.conn.query_all)
                vals = q_all(q.match(q.index("elements-by-key"), k))
                return {**op, "type": "ok",
                        "value": independent.tuple_(k, list(vals))}
        elif self.mode == "multimonotonic":
            # multimonotonic.clj:76-107: blind single-txn writes of
            # {key: value} maps; reads pin a timestamp and fetch a
            # subset of registers with their instance ts.
            if f == "write":
                self.conn.query([
                    q.if_(q.exists(q.ref_(q.class_("registers"), k)),
                          q.update(q.ref_(q.class_("registers"), k),
                                   {"data": {"value": val}}),
                          q.create(q.ref_(q.class_("registers"), k),
                                   {"data": {"value": val}}))
                    for k, val in v.items()])
                return {**op, "type": "ok"}
            if f == "read":
                ks = list(v)
                res = self.conn.query(
                    [q.time("now")] +
                    [q.when(q.exists(q.ref_(q.class_("registers"), k)),
                            q.get_(q.ref_(q.class_("registers"), k)))
                     for k in ks])
                ts, instances = res[0], res[1:]
                registers = {}
                for k, inst in zip(ks, instances):
                    if isinstance(inst, dict):
                        registers[k] = {
                            "ts": inst.get("ts"),
                            "value": (inst.get("data") or {}).get("value")}
                return {**op, "type": "ok",
                        "value": {"ts": ts, "registers": registers}}
        elif self.mode == "internal":
            return self._internal_dispatch(q, op, f, v)
        elif self.mode == "g2":
            if f == "insert":
                k, ids = (v.key, v.value) if independent.is_tuple(v) \
                    else (v[0], v[1])
                a_id, b_id = ids
                tbl = "a" if a_id is not None else "b"
                the_id = a_id if a_id is not None else b_id
                empty = lambda n: q.equals(  # noqa: E731
                    q.select(["data"],
                             q.paginate(q.match(q.index(f"{n}-by-key"),
                                                k), size=1)), [])
                res = self.conn.query(q.if_(
                    q.and_(empty("a"), empty("b")),
                    q.do(q.create(q.ref_(q.class_(tbl), the_id),
                                  {"data": {"key": k, "id": the_id}}),
                         True),
                    False))
                return {**op, "type": "ok" if res else "fail"}
        return {**op, "type": "fail", "error": f"unknown f {f!r}"}


# ---------------------------------------------------------------------------
# pages: transactional isolation of pagination (pages.clj)
# ---------------------------------------------------------------------------

class PagesChecker(jchecker.Checker):
    """Every read must be expressible as a union of add-groups: pick an
    element, cross off its whole group, and if any group member is
    missing that's a pagination-isolation error (pages.clj:68-106)."""

    def check(self, test, history, opts):
        invoked, failed = set(), set()
        idx: dict = {}
        for o in history:
            if o.get("f") != "add":
                continue
            group = tuple(o.get("value") or ())
            if o.get("type") == "invoke":
                invoked.add(group)
            elif o.get("type") == "fail":
                failed.add(group)
        for group in invoked - failed:
            gs = frozenset(group)
            for e in group:
                assert e not in idx, "Elements must be unique"
                idx[e] = gs
        errs = []
        ok_reads = 0
        for o in history:
            if o.get("type") != "ok" or o.get("f") != "read":
                continue
            ok_reads += 1
            read = set(o.get("value") or ())
            while read:
                e = next(iter(read))
                group = idx.get(e, frozenset({e}))
                if not group <= read:
                    errs.append({"expected": sorted(group),
                                 "found": sorted(read & group)})
                read -= group
        return {"valid?": not errs,
                "ok-read-count": ok_reads,
                "error-count": len(errs),
                "first-error": errs[0] if errs else None}


def _pages_workload(opts: dict) -> dict:
    import random as _r
    nodes = opts.get("nodes") or ["n1", "n2", "n3", "n4", "n5"]
    n = opts.get("pages-elements", 1000)
    group_size = opts.get("pages-group-size", 4)
    per_key = opts.get("pages-ops-per-key", 256)

    def gen_key(k):
        rng = _r.Random(f"pages:{k}")
        vals = list(range(-n, n))
        rng.shuffle(vals)
        groups = [vals[i:i + group_size]
                  for i in range(0, len(vals), group_size)]
        # ~4:1 adds:reads like the reference's (mix [adds x4 reads]) —
        # but interleaved into ONE sequence: our pure mix would step
        # four independent copies of the adds Seq, re-inserting every
        # group (the duplicate creates then fail and poison the
        # checker's group index).
        ops = []
        for g in groups:
            ops.append({"type": "invoke", "f": "add", "value": g})
            if rng.random() < 0.25:
                ops.append({"type": "invoke", "f": "read",
                            "value": None})
        return gen.stagger(1 / 5, gen.limit(per_key, gen.Seq.of(ops)))

    return {
        "client": FaunaClient(mode="pages",
                              naive_reads=bool(
                                  opts.get("pages-naive-reads"))),
        "generator": independent.concurrent_generator(
            2 * len(nodes), range(100000), gen_key),
        "checker": independent.checker(PagesChecker()),
    }


# ---------------------------------------------------------------------------
# multimonotonic: increment-only registers must never read backwards
# (multimonotonic.clj)
# ---------------------------------------------------------------------------

def _ts_sort_key(ts):
    """Sortable key for a read timestamp: Fauna @ts values arrive as
    microsecond ints or decoded ISO-8601 strings. Lexicographic string
    comparison mis-orders timestamps with differing fractional-second
    precision ('...T10:00:00Z' vs '...T10:00:00.5Z'), so ISO strings
    are parsed to epoch seconds; numerics are scaled to seconds too
    (micro/milli magnitudes detected by range, post-2001 epochs), so a
    history mixing raw and decoded forms still orders by actual time.
    Unparseable strings sort after everything, amongst themselves."""
    if isinstance(ts, str):
        try:
            from ..util import iso_to_epoch
            return (0, iso_to_epoch(ts))
        except ValueError:
            return (1, ts)
    v = float(ts)
    if v >= 1e14:        # microseconds since epoch (>= ~2001-09)
        v /= 1e6
    elif v >= 1e11:      # milliseconds since epoch
        v /= 1e3
    return (0, v)


class TsOrderChecker(jchecker.Checker):
    """Order reads by their read timestamp and fold a running lower
    bound per register; any read below the bound means timestamp order
    disagrees with observed values (multimonotonic.clj:256-272)."""

    def check(self, test, history, opts):
        reads = [o for o in history
                 if o.get("type") == "ok" and o.get("f") == "read"
                 and (o.get("value") or {}).get("ts") is not None]
        reads.sort(key=lambda o: _ts_sort_key(o["value"]["ts"]))
        inferred: dict = {}
        errs = []
        for o in reads:
            state = {k: r["value"]
                     for k, r in o["value"]["registers"].items()}
            bad = {k: [inferred[k], {"value": val,
                                     "op-index": o.get("index")}]
                   for k, val in state.items()
                   if k in inferred and val < inferred[k]["value"]}
            if bad:
                errs.append({"observed": state, "op": o, "errors": bad})
            for k, val in state.items():
                if k not in inferred or inferred[k]["value"] <= val:
                    inferred[k] = {"value": val,
                                   "op-index": o.get("index")}
        return {"valid?": not errs, "errors": errs[:8],
                "error-count": len(errs)}


class ReadSkewChecker(jchecker.Checker):
    """Read-skew hunt over increment-only registers: for each key,
    order reads by observed value and add edges between consecutive
    value classes; a cycle in the union graph means two reads each saw
    the other's future (the cycle-detection formulation sketched at
    multimonotonic.clj:274-299 — the reference stubs the check out;
    this implements it)."""

    def check(self, test, history, opts):
        reads = [o for o in history
                 if o.get("type") == "ok" and o.get("f") == "read"]
        states = [{k: r["value"]
                   for k, r in (o.get("value") or {}).get(
                       "registers", {}).items()} for o in reads]
        by_key: dict = {}
        for i, st in enumerate(states):
            for k, val in st.items():
                by_key.setdefault(k, {}).setdefault(val, []).append(i)
        edges: dict[int, set] = {i: set() for i in range(len(states))}
        for k, classes in by_key.items():
            vals = sorted(classes)
            for lo, hi in zip(vals, vals[1:]):
                for a in classes[lo]:
                    edges[a] |= set(classes[hi])
        # iterative Tarjan: any SCC with >1 node is a skew cycle
        index: dict = {}
        low: dict = {}
        on: set = set()
        stack: list = []
        sccs = []
        counter = [0]
        for root in edges:
            if root in index:
                continue
            work = [(root, iter(edges[root]))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on.add(root)
            while work:
                v, it = work[-1]
                adv = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on.add(w)
                        work.append((w, iter(edges[w])))
                        adv = True
                        break
                    if w in on:
                        low[v] = min(low[v], index[w])
                if adv:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[v])
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))
        errs = [{"cycle-reads": [reads[i].get("index") for i in comp],
                 "states": [states[i] for i in comp]} for comp in sccs]
        return {"valid?": not errs, "errors": errs[:8],
                "error-count": len(errs)}


class _MMWriter(gen.Generator):
    """Per-thread writer (via each_thread): blind writes to a key
    derived from the current process, restarting from 0 when a crash
    remaps the process (multimonotonic.clj:314-341). Registers written
    keys in the shared `active` dict so readers can pick subsets."""

    def __init__(self, active: dict, key=None, value: int = 0):
        self.active = active
        self.key = key
        self.value = value

    def op(self, test, ctx):
        thread = next(iter(ctx.workers))
        p = ctx.workers[thread]
        k, v = (self.key, self.value) if p == self.key else (p, 0)
        self.active[thread] = k
        o = gen.fill_in_op({"f": "write", "value": {k: v}}, ctx)
        if o is gen.PENDING:
            return (o, self)
        return (o, _MMWriter(self.active, k, v + 1))

    def update(self, test, ctx, event):
        return self


def _mm_workload(opts: dict) -> dict:
    import random as _r
    conc = int(str(opts.get("concurrency", 5)).rstrip("n")) or 5
    active: dict = {}

    def read(test=None, ctx=None):
        ks = sorted(set(active.values())) or [0]
        n = _r.randint(1, len(ks))
        return {"type": "invoke", "f": "read",
                "value": sorted(_r.sample(ks, n))}

    # Per-branch staggers: a single stagger around the reserve would
    # rate-limit the merged stream, and soonest-op tie-breaking then
    # starves the reader branch (a free writer thread wins every tick).
    return {
        "client": FaunaClient(mode="multimonotonic"),
        "generator": gen.reserve(
            max(1, conc // 2),
            gen.stagger(opts.get("mm-write-stagger", 1 / 200),
                        gen.each_thread(_MMWriter(active))),
            gen.stagger(opts.get("mm-read-stagger", 1 / 100), read)),
        "checker": jchecker.compose({
            "ts-order": TsOrderChecker(),
            "read-skew": ReadSkewChecker(),
        }),
    }


# ---------------------------------------------------------------------------
# internal transaction consistency (internal.clj)
# ---------------------------------------------------------------------------

class InternalChecker(jchecker.Checker):
    """Each create txn must NOT see its new cat in the pre-create read
    and MUST see it in the post-create read (both inside the same txn);
    change-type moves a cat between both index reads atomically
    (internal.clj:140-206)."""

    @staticmethod
    def _op_errors(op):
        v = op.get("value") or {}
        f = op.get("f")
        errs = []
        if f in ("create-tabby-let", "create-tabby-obj",
                 "create-tabby-arr"):
            name = ((v.get("tabby") or {}).get("data") or {}).get("name")
            if name in (v.get("tabbies-0") or []):
                errs.append({"type": "present-before-create",
                             "name": name, "op-index": op.get("index")})
            if name not in (v.get("tabbies-1") or []):
                errs.append({"type": "missing-after-create",
                             "name": name, "op-index": op.get("index")})
        elif f == "change-type":
            cat = v.get("cat")
            name = ((cat or {}).get("data") or {}).get("name")
            if name is not None:
                if name in (v.get("tabbies") or []):
                    errs.append({"type": "present-after-change",
                                 "name": name,
                                 "op-index": op.get("index")})
                if name not in (v.get("calicos") or []):
                    errs.append({"type": "missing-after-change",
                                 "name": name,
                                 "op-index": op.get("index")})
        return errs

    def check(self, test, history, opts):
        errors = [e for o in history if o.get("type") == "ok"
                  for e in self._op_errors(o)]
        return {"valid?": not errors,
                "error-count": len(errors),
                "error-types": sorted({e["type"] for e in errors}),
                "errors": errors[:16]}


def _internal_workload(opts: dict) -> dict:
    counter = {"i": -1}

    def create(f):
        def g(test=None, ctx=None):
            counter["i"] += 1
            return {"type": "invoke", "f": f, "value": counter["i"]}
        return g

    return {
        "client": FaunaClient(mode="internal"),
        "generator": gen.stagger(0.1, gen.mix(
            [create("create-tabby-let"), create("create-tabby-obj"),
             create("create-tabby-arr"),
             gen.repeat_gen({"type": "invoke", "f": "change-type",
                             "value": None})])),
        "checker": InternalChecker(),
    }


# ---------------------------------------------------------------------------
# replica-aware partitions (faunadb/nemesis.clj:20-55 + topology.clj:12-30)
# ---------------------------------------------------------------------------

def nodes_by_replica(nodes: list, replica_count: int = 3) -> dict:
    """The reference's initial layout: node i lives in replica
    i mod replica-count (topology.clj:12-30)."""
    out: dict = {}
    for i, n in enumerate(nodes):
        out.setdefault(f"replica-{i % replica_count}", []).append(n)
    return out


def intra_replica_grudge(replica_count: int = 3):
    """Partition INSIDE one randomly-chosen replica; nodes of other
    replicas keep uninterrupted connectivity to both halves
    (nemesis.clj:29-41)."""
    import random as _r

    def f(nodes):
        groups = sorted(nodes_by_replica(nodes, replica_count).items())
        _replica, members = _r.choice(groups)
        members = _r.sample(members, len(members))
        return jnemesis.complete_grudge(jnemesis.bisect(members))
    return f


def inter_replica_grudge(replica_count: int = 3):
    """Partition BETWEEN replicas: split the set of replicas in half
    and cut every cross-half link (nemesis.clj:42-55)."""
    import random as _r

    def f(nodes):
        groups = list(nodes_by_replica(nodes, replica_count).values())
        _r.shuffle(groups)
        halves = jnemesis.bisect(groups)
        flat = [[n for g in h for n in g] for h in halves]
        return jnemesis.complete_grudge(flat)
    return f


def single_node_grudge(nodes):
    """Isolate one node from everyone (nemesis.clj:20-28)."""
    return jnemesis.complete_grudge(jnemesis.split_one(nodes))


FAUNA_NEMESES = {
    "partition": jnemesis.partition_random_halves,
    "single-node-partition":
        lambda: jnemesis.partitioner(single_node_grudge),
    "intra-replica-partition":
        lambda: jnemesis.partitioner(intra_replica_grudge()),
    "inter-replica-partition":
        lambda: jnemesis.partitioner(inter_replica_grudge()),
}


# ---------------------------------------------------------------------------
# topology-change nemesis (topology.clj + auto.clj:107-124,273-280)
# ---------------------------------------------------------------------------

class TopologyNemesis:
    """Grow and shrink the cluster under load: `add-node` re-joins a
    removed node to the current primary (`faunadb-admin join -r
    <replica>`), `remove-node` removes it by host id (`faunadb-admin
    remove $(faunadb-admin host-id ...)`). Best-effort like the
    reference — topology drift after crashes is tolerated."""

    def __init__(self):
        self.removed: list = []

    def setup(self, test):
        return self

    def invoke(self, test, op):
        nodes = test.get("nodes") or []
        f = op.get("f")
        try:
            if f == "remove-node":
                cand = [n for n in nodes if n not in self.removed]
                if len(cand) <= (len(nodes) // 2 + 1):
                    return {**op, "type": "info", "value": "too-few"}
                node = cand[-1]
                sess = control.session(test, cand[0]).su()
                sess.exec("sh", "-c",
                          f"faunadb-admin remove "
                          f"$(faunadb-admin host-id {node})")
                self.removed.append(node)
                return {**op, "type": "info", "value": node}
            if f == "add-node":
                if not self.removed:
                    return {**op, "type": "info", "value": "none-removed"}
                node = self.removed.pop()
                primary = nodes[0]
                sess = control.session(test, node).su()
                sess.exec("faunadb-admin", "join", "-r", "replica-0",
                          primary)
                return {**op, "type": "info", "value": node}
            return {**op, "type": "info", "value": f"bad f {f!r}"}
        except Exception as e:  # noqa: BLE001 — nemesis never crashes a run
            return {**op, "type": "info", "error": str(e)[:120]}

    def teardown(self, test):
        pass


def topology_generator(interval: float = 15.0):
    return gen.stagger(interval, gen.cycle(gen.Seq.of([
        {"type": "info", "f": "remove-node"},
        {"type": "info", "f": "add-node"}])))


def workloads(opts: dict | None = None) -> dict:
    std = standard_workloads(opts)
    out = {}
    for k in ("register", "set", "bank", "monotonic", "g2"):
        def make(name=k):
            pkg = dict(std[name]())
            pkg.setdefault("client", FaunaClient(mode=name))
            return pkg
        out[k] = make
    o = opts or {}
    out["pages"] = lambda: _pages_workload(o)
    out["multimonotonic"] = lambda: _mm_workload(o)
    out["internal"] = lambda: _internal_workload(o)
    return out


def faunadb_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wname = opts.get("workload", "register")
    choice = opts.get("nemesis", "partition")
    if choice == "topology":
        nem = TopologyNemesis()
    else:
        nem = FAUNA_NEMESES.get(choice, FAUNA_NEMESES["partition"])()
    return suite_test(
        "faunadb", wname, opts, workloads(opts),
        db=FaunaDB(opts.get("version", "2.5.5")),
        client=opts.get("client"),
        nemesis=nem,
        os_setup=os_setup.debian())


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: faunadb_test(
            {**tmap,
             "workload": resolve_workload(args, tmap, "register")}),
        name="faunadb",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

"""Elasticsearch suite.

Counterpart of elasticsearch/src/jepsen/elasticsearch (862 LoC): a
deb-installed ES cluster and the set workload that exposed its
dirty-window data loss — documents indexed during partitions, a final
refresh + search that must see every acknowledged doc. Client is plain
HTTP (the reference goes through the native transport client).

The port's copy of `jepsen_tpu/suites/elasticsearch.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

from .. import checker as jchecker
from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis, os_setup
from ..workloads import set_workload
from . import base_opts, nemesis_cycle
from .sql import resolve

VERSION = "1.5.0"
LOGFILE = "/var/log/elasticsearch/elasticsearch.log"
INDEX = "jepsen"


class ElasticsearchDB(jdb.DB, jdb.LogFiles):
    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        sess = control.current_session().su()
        url = (f"https://download.elastic.co/elasticsearch/elasticsearch/"
               f"elasticsearch-{self.version}.deb")
        sess.exec("sh", "-c",
                  f"wget -q -O /tmp/es.deb {url} && "
                  f"dpkg -i --force-confnew /tmp/es.deb")
        nodes = test.get("nodes", [node])
        hosts = json.dumps([f"{n}:9300" for n in nodes])
        cfg = "\n".join([
            f"cluster.name: jepsen",
            f"node.name: {node}",
            f"network.host: {node}",
            f"discovery.zen.ping.unicast.hosts: {hosts}",
            f"discovery.zen.minimum_master_nodes: "
            f"{len(nodes) // 2 + 1}",
        ])
        sess.exec("sh", "-c",
                  f"cat > /etc/elasticsearch/elasticsearch.yml "
                  f"<< 'EOF'\n{cfg}\nEOF")
        sess.exec("service", "elasticsearch", "restart")

    def teardown(self, test, node):
        sess = control.current_session().su()
        sess.exec_ok("service", "elasticsearch", "stop")
        sess.exec("rm", "-rf", "/var/lib/elasticsearch/jepsen")

    def log_files(self, test, node):
        return [LOGFILE]


class ESClient(jclient.Client):
    """Set ops over the document API: add = index doc with id=value
    (write concern: wait_for_active_shards), read = refresh + match_all
    search."""

    def __init__(self, port: int = 9200, node: str | None = None,
                 timeout: float = 5.0):
        self.port = port
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return ESClient(self.port, node, self.timeout)

    def _url(self, test, path: str) -> str:
        host, port = resolve(self.node, self.port, test or {})
        return f"http://{host}:{port}{path}"

    def _request(self, test, path: str, body: dict | None = None,
                 method: str = "GET") -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self._url(test, path), data=data, method=method,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read() or b"{}")

    def invoke(self, test, op):
        crash = "fail" if op["f"] == "read" else "info"
        try:
            if op["f"] == "add":
                v = int(op["value"])
                self._request(test, f"/{INDEX}/doc/{v}?op_type=create",
                              {"value": v}, "PUT")
                return {**op, "type": "ok"}
            if op["f"] == "read":
                self._request(test, f"/{INDEX}/_refresh", None, "POST")
                out = self._request(
                    test, f"/{INDEX}/_search",
                    {"size": 100000,
                     "query": {"match_all": {}}}, "POST")
                hits = out.get("hits", {}).get("hits", [])
                return {**op, "type": "ok",
                        "value": sorted(int(h["_id"]) for h in hits)}
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except urllib.error.HTTPError as e:
            if e.code == 409:   # op_type=create conflict: definite
                return {**op, "type": "fail", "error": "conflict"}
            if 400 <= e.code < 500:
                return {**op, "type": "fail", "error": f"http-{e.code}"}
            return {**op, "type": crash, "error": f"http-{e.code}"}
        except OSError as e:
            return {**op, "type": crash, "error": str(e)[:160]}


DIRTY_INDEX = "dirty_read"


class DirtyReadClient(ESClient):
    """Dirty-read ops (dirty_read.clj:32-104): write = index doc id=v,
    read = GET by id (found -> ok, absent -> fail), refresh = POST
    _refresh retried until every shard reports success, strong-read =
    refresh-backed match_all search returning the full id set."""

    def open(self, test, node):
        return DirtyReadClient(self.port, node, self.timeout)

    def invoke(self, test, op):
        crash = "fail" if op["f"] in ("read", "strong-read") else "info"
        try:
            if op["f"] == "write":
                v = int(op["value"])
                self._request(test, f"/{DIRTY_INDEX}/doc/{v}",
                              {"id": v}, "PUT")
                return {**op, "type": "ok"}
            if op["f"] == "read":
                try:
                    out = self._request(
                        test, f"/{DIRTY_INDEX}/doc/{int(op['value'])}")
                except urllib.error.HTTPError as e:
                    if e.code == 404:
                        return {**op, "type": "fail", "error": "absent"}
                    raise
                return {**op, "type": "ok" if out.get("found", True)
                        else "fail"}
            if op["f"] == "refresh":
                # all shards must acknowledge, else the strong read can
                # miss committed docs; paced retries span the post-
                # nemesis heal window (dirty_read.clj:60-82 retries
                # under a 120s op timeout)
                import time as _time
                for i in range(60):
                    out = self._request(test, f"/{DIRTY_INDEX}/_refresh",
                                        None, "POST")
                    sh = out.get("_shards") or {}
                    if sh.get("total", 0) == sh.get("successful", 0):
                        return {**op, "type": "ok"}
                    if i < 59:
                        _time.sleep(float(test.get(
                            "refresh-retry-interval", 2.0)))
                return {**op, "type": "info", "error": "refresh-partial"}
            if op["f"] == "strong-read":
                out = self._request(
                    test, f"/{DIRTY_INDEX}/_search",
                    {"size": 100000, "query": {"match_all": {}}}, "POST")
                hits = out.get("hits", {}).get("hits", [])
                return {**op, "type": "ok",
                        "value": sorted(int(h["_id"]) for h in hits)}
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except urllib.error.HTTPError as e:
            if 400 <= e.code < 500:
                return {**op, "type": "fail", "error": f"http-{e.code}"}
            return {**op, "type": crash, "error": f"http-{e.code}"}
        except OSError as e:
            return {**op, "type": crash, "error": str(e)[:160]}


class RWGen(gen.Generator):
    """dirty_read.clj:160-189: the first `w` threads write an
    ever-incrementing value, recording the in-flight write per node;
    the rest read their node's most recent in-flight write — aiming to
    observe an uncommitted write in the instant before a crash. Pure:
    the counter and in-flight vector advance in `update` on each
    dispatched write invocation."""

    __slots__ = ("w", "next_write", "in_flight")

    def __init__(self, w: int, next_write: int = 0,
                 in_flight: tuple = ()):
        self.w = w
        self.next_write = next_write
        self.in_flight = in_flight

    def _nodes(self, test) -> int:
        return max(1, len(test.get("nodes") or ()))

    @staticmethod
    def _node_of(ctx, p, n_nodes: int) -> int:
        """Node index for a process: clients bind to nodes by THREAD
        (interpreter nodes[wid % len(nodes)]), and a crashed process
        retires to p + concurrency — so the thread, not the raw
        process id, decides which node an op lands on."""
        t = ctx.process_to_thread(p)
        return t % n_nodes if isinstance(t, int) else 0

    def op(self, test, ctx):
        p = ctx.some_free_process()
        if p is None:
            return (gen.PENDING, self)
        t = ctx.process_to_thread(p)
        n_nodes = self._nodes(test)
        if isinstance(t, int) and t < self.w:
            o = {"type": "invoke", "f": "write", "value": self.next_write,
                 "process": p, "time": ctx.time}
        else:
            inf = self.in_flight or (0,) * n_nodes
            o = {"type": "invoke", "f": "read",
                 "value": inf[self._node_of(ctx, p, n_nodes)],
                 "process": p, "time": ctx.time}
        return (o, self)

    def update(self, test, ctx, event):
        if event.get("type") == "invoke" and event.get("f") == "write":
            n_nodes = self._nodes(test)
            inf = list(self.in_flight or (0,) * n_nodes)
            n = self._node_of(ctx, event.get("process"), n_nodes)
            inf[n] = event["value"]
            return RWGen(self.w, self.next_write + 1, tuple(inf))
        return self


class DirtyReadChecker(jchecker.Checker):
    """dirty_read.clj:106-156: a read is dirty when its value appears
    in NO final strong read (it observed a write that never committed);
    an acknowledged write is lost when no strong read contains it; the
    per-node strong reads must also agree with each other."""

    def check(self, test, history, opts):
        ok = [o for o in history if o.get("type") == "ok"]
        writes = {o["value"] for o in ok if o.get("f") == "write"}
        reads = {o["value"] for o in ok if o.get("f") == "read"}
        strong = [set(o["value"] or ()) for o in ok
                  if o.get("f") == "strong-read"]
        if not strong:
            return {"valid?": "unknown", "error": "no strong reads"}
        on_all = set.intersection(*strong)
        on_some = set.union(*strong)
        not_on_all = on_some - on_all
        dirty = reads - on_some
        lost = writes - on_some
        some_lost = writes - on_all
        agree = on_all == on_some
        return {
            "valid?": agree and not dirty and not lost,
            "nodes-agree?": agree,
            "strong-read-count": len(strong),
            "read-count": len(reads),
            "on-all-count": len(on_all),
            "on-some-count": len(on_some),
            "unchecked-count": len(on_some - reads),
            "not-on-all-count": len(not_on_all),
            "not-on-all": sorted(not_on_all),
            "dirty-count": len(dirty),
            "dirty": sorted(dirty),
            "lost-count": len(lost),
            "lost": sorted(lost),
            "some-lost-count": len(some_lost),
            "some-lost": sorted(some_lost),
        }


def dirty_read_gen(opts: dict) -> gen.Generator:
    """The reference's phase structure (dirty_read.clj:208-222):
    staggered writes/reads under the nemesis, stop, a per-client
    refresh, quiescence, then a per-client strong read."""
    conc = int(opts.get("concurrency", 6) or 6)
    writers = max(1, conc // 3)
    return gen.phases(
        gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(gen.stagger(0.1, RWGen(writers)),
                        nemesis_cycle(opts.get("nemesis-interval", 10)))),
        gen.nemesis(gen.once({"type": "info", "f": "stop"})),
        gen.clients(gen.each_thread(gen.once({"f": "refresh"}))),
        gen.log_gen("Waiting for quiescence"),
        gen.sleep(opts.get("quiesce", 10)),
        gen.clients(gen.each_thread(gen.once({"f": "strong-read"}))),
    )


def workloads(opts: dict | None = None) -> dict:
    opts = opts or {}
    return {
        "set": lambda: set_workload.test(n=opts.get("set-size", 500)),
        "dirty-read": lambda: {
            "client": DirtyReadClient(),
            "generator": dirty_read_gen(opts),
            "checker": DirtyReadChecker(),
            "full-generator": True,   # phases carry their own nemesis
        },
    }


def elasticsearch_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    name = opts.get("workload", "set")
    wl = workloads(opts)[name]()
    if wl.get("full-generator"):
        generator = wl["generator"]    # phases carry their own nemesis
    else:
        generator = gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(wl["generator"],
                        nemesis_cycle(opts.get("nemesis-interval", 10))))
    test = {
        "name": f"elasticsearch {name}",
        "os": os_setup.debian(),
        "db": ElasticsearchDB(opts.get("version", VERSION)),
        "client": opts.get("client") or wl.get("client") or ESClient(),
        "nemesis": jnemesis.partition_random_halves(),
        "checker": jchecker.compose({
            name: wl["checker"],
            "perf": jchecker.perf_checker(),
        }),
        "generator": generator,
        "workload": name,
    }
    for k, v in opts.items():
        test.setdefault(k, v)
    return test


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: elasticsearch_test(
            {**tmap, "workload": resolve_workload(args, tmap, "set")}),
        name="elasticsearch",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

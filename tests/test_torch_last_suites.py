"""The port's last suites against the reference's: `crate` (over the
ported SQL layer and pg wire driver), `logcabin` (TreeOps over the
control plane), `elasticsearch` (urllib's HTTP) and `charybdefs` (file
I/O through faultfs over the control plane).

- The reference's own cases (tests/test_more_suites.py and
  tests/test_template_suites.py) on the port's copies.
- `MultiVersionChecker` and `DirtyReadChecker` on seeded histories:
  each package's verdict, exactly.
- The clients op for op against `FakePGServer`, `FakeESServer`, the
  TreeOps remote (tests/fake_torch_treeops.py) and the dummy remote:
  the same completions, errors included; the TreeOps remote answers
  the reference's client as it answers the port's.
- The test maps, workload menus, generators (under a seeded `random`)
  and DB setup commands on a dummy remote as the reference's.
- End to end: each suite's own `main(["test", "--dummy", "--device",
  "cpu", ...])` against its fake, the history stored; both packages'
  `analyze --backend cpu` of the stored run, in turn on one path, give
  the same results (per key for registers) and the same files.
"""

import contextlib
import copy
import json
import random
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jepsen_tpu.control as ref_control
import jepsen_tpu.core as ref_core
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.net as ref_net
import jepsen_tpu.suites as ref_suites
import jepsen_tpu.suites.charybdefs as ref_charybdefs
import jepsen_tpu.suites.crate as ref_crate
import jepsen_tpu.suites.elasticsearch as ref_elasticsearch
import jepsen_tpu.suites.logcabin as ref_logcabin
from jepsen_tpu.store import Store as RefStore
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.core as port_core
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.net as port_net
import jepsen_tpu_torch.suites as port_suites
import jepsen_tpu_torch.suites.charybdefs as port_charybdefs
import jepsen_tpu_torch.suites.crate as port_crate
import jepsen_tpu_torch.suites.elasticsearch as port_elasticsearch
import jepsen_tpu_torch.suites.logcabin as port_logcabin
from jepsen_tpu_torch.store import Store as PortStore

from fake_misc import FakeESServer
from fake_sql import FakePGServer
from fake_torch_treeops import FakeTreeOpsRemote
from test_torch_baseline_suites import (fake_hosts, map_shape,
                                        no_threads_left, per_key, plain,
                                        recheck_in_turn, run_main,
                                        same_recheck)
from test_torch_cli import reference_env  # noqa: F401
from test_torch_core_run import no_workers_left
from test_torch_generator import perfect, simulate
from test_torch_more_suites import invoke_all, strip_plot_errors
from test_torch_plots import block_matplotlib

REF = dict(ind=ref_ind, gen=ref_gen, control=ref_control, net=ref_net,
           core=ref_core, Store=RefStore, suites=ref_suites,
           crate=ref_crate, logcabin=ref_logcabin,
           elasticsearch=ref_elasticsearch, charybdefs=ref_charybdefs)
PORT = dict(ind=port_ind, gen=port_gen, control=port_control,
            net=port_net, core=port_core, Store=PortStore,
            suites=port_suites, crate=port_crate, logcabin=port_logcabin,
            elasticsearch=port_elasticsearch, charybdefs=port_charybdefs)
PKGS = (("ref", REF), ("port", PORT))

#: The suites of this file, with each one's `<db>_test`.
SUITES = {"crate": "crate_test", "logcabin": "logcabin_test",
          "elasticsearch": "elasticsearch_test",
          "charybdefs": "charybdefs_test"}


def run_suite(tmp_path, P, make_test, srv, opts=None):
    """tests/test_more_suites.py's `run_suite` in package P: the suite's
    test map against `srv`, without daemons or a nemesis."""
    test = make_test({
        "ssh": {"dummy": True}, "time-limit": 1.0,
        "db-hosts": fake_hosts(srv), **(opts or {}),
    })
    for k in ("db", "os", "nemesis"):
        test.pop(k, None)
    test["net"] = P["net"].noop()
    test["store"] = P["Store"](tmp_path / "store")
    return P["core"].run(test)


# ---------------------------------------------------------------------------
# The reference's cases: tests/test_more_suites.py (crate, elasticsearch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make_test,needle", [
    (port_crate.crate_test, "crate"),
    (port_elasticsearch.elasticsearch_test, "elasticsearch"),
])
def test_db_setup_against_dummy_remote(make_test, needle):
    test = make_test({"ssh": {"dummy": True}})
    port_control.on_nodes(test, lambda t, n: t["db"].setup(t, n))
    cmds = "\n".join(str(p) for _n, kind, p in test["remote"].actions
                     if kind == "execute")
    assert needle in cmds


def test_elasticsearch_set_end_to_end(tmp_path):
    # The set's 500 adds and its final read must all land inside the
    # time limit, or the set is never read: the reference's 1 s held
    # only while the machine was idle (the adds take 0.8 s there). The
    # run lasts about 10 s whatever the limit up to 10 s (it ends at
    # the nemesis schedule's first op, after its 10 s sleep), so a 10 s
    # limit costs no time.
    with FakeESServer() as srv:
        test = run_suite(tmp_path, PORT,
                         port_elasticsearch.elasticsearch_test, srv,
                         {"time-limit": 10.0})
    r = test["results"]
    assert r["valid?"] is True, r
    assert r["set"]["ok-count"] > 10


def test_crate_register_end_to_end(tmp_path):
    with FakePGServer() as srv:
        test = run_suite(tmp_path, PORT, port_crate.crate_test, srv,
                         {"workload": "register", "device": "cpu"})
    assert test["results"]["valid?"] is True


def test_crate_version_divergence_end_to_end(tmp_path):
    with FakePGServer() as srv:
        test = run_suite(tmp_path, PORT, port_crate.crate_test, srv,
                         {"workload": "version-divergence",
                          "keys-concurrent": 4, "readers": 2})
    r = test["results"]
    assert r["valid?"] is True, r
    # at least one key actually observed versioned reads
    assert any(v.get("version-count", 0) > 0
               for v in r["results"].values())


def test_crate_lost_updates_end_to_end(tmp_path):
    with FakePGServer() as srv:
        # key-count bounded so every key finishes its adds+quiesce+read
        # phase inside the outer time limit (a cut-off key's set is
        # never read -> unknown, the reference's behavior too)
        test = run_suite(tmp_path, PORT, port_crate.crate_test, srv,
                         {"workload": "lost-updates", "time-limit": 3.0,
                          "quiesce": 0.5, "keys-concurrent": 4,
                          "key-count": 2})
    r = test["results"]
    assert r["valid?"] is True, r
    # the serializable fake must never lose an acked add
    assert any(v.get("ok-count", 0) > 0 for v in r["results"].values())


def test_multiversion_checker_detects_divergence():
    c = port_crate.MultiVersionChecker()
    ok = [{"type": "ok", "f": "read",
           "value": {"value": 5, "version": 1}},
          {"type": "ok", "f": "read",
           "value": {"value": 6, "version": 2}}]
    assert c.check({}, ok, {})["valid?"] is True
    # same _version serving two different values: divergence
    bad = ok + [{"type": "ok", "f": "read",
                 "value": {"value": 99, "version": 2}}]
    res = c.check({}, bad, {})
    assert res["valid?"] is False
    assert res["multis"] == {2: [6, 99]}
    # unread rows (value None) don't count
    none = [{"type": "ok", "f": "read", "value": None}]
    assert c.check({}, none, {})["valid?"] is True


def test_crate_lost_updates_client_cas():
    """The add path's optimistic `AND _version = ?` guard: a version
    that moved between read and update is a definite fail, and the
    final read returns every acked element (lost_updates.clj:73-98)."""
    with FakePGServer() as srv:
        test = {"db-hosts": fake_hosts(srv)}
        a = port_crate.CrateClient("lost-updates").open(test, "n1")
        b = port_crate.CrateClient("lost-updates").open(test, "n1")

        def kv(v):
            return {"type": "invoke", "f": "add", "process": 0,
                    "value": port_ind.tuple_(7, v)}

        assert a.invoke(test, kv(1))["type"] == "ok"     # insert
        assert b.invoke(test, kv(2))["type"] == "ok"     # rmw update
        r = a.invoke(test, {"type": "invoke", "f": "read", "process": 0,
                            "value": port_ind.tuple_(7, None)})
        assert r["type"] == "ok" and r["value"].value == [1, 2]
        rows = port_crate.sql._rows(a.conn.query(
            'SELECT elements, "_version" FROM lu_sets WHERE id = 7'))
        ver = int(rows[0][1])
        assert b.invoke(test, kv(3))["type"] == "ok"     # version moves
        res = a.conn.query(
            f"UPDATE lu_sets SET elements = '9' "
            f"WHERE id = 7 AND _version = {ver}")
        assert port_crate._rowcount(res) == 0            # CAS lost
        a.close(test)
        b.close(test)


def test_crate_workload_registry_has_reference_families():
    wls = port_crate.workloads({})
    assert {"version-divergence", "lost-updates", "register", "set",
            "wr", "monotonic", "long-fork"} <= set(wls)


def test_es_dirty_read_checker_verdicts():
    c = port_elasticsearch.DirtyReadChecker()

    def h(writes, reads, strongs):
        out = [{"type": "ok", "f": "write", "value": v} for v in writes]
        out += [{"type": "ok", "f": "read", "value": v} for v in reads]
        out += [{"type": "ok", "f": "strong-read", "value": list(s)}
                for s in strongs]
        return out

    good = c.check({}, h([0, 1], [0], [{0, 1}, {0, 1}]), {})
    assert good["valid?"] is True and good["nodes-agree?"] is True
    dirty = c.check({}, h([0, 1], [0, 2], [{0, 1}, {0, 1}]), {})
    assert dirty["valid?"] is False and dirty["dirty"] == [2]
    lost = c.check({}, h([0, 1], [0], [{0}, {0}]), {})
    assert lost["valid?"] is False and lost["lost"] == [1]
    div = c.check({}, h([0, 1], [0], [{0, 1}, {0}]), {})
    assert div["valid?"] is False and div["nodes-agree?"] is False
    assert div["not-on-all"] == [1] and div["some-lost"] == [1]
    unknown = c.check({}, h([0], [0], []), {})
    assert unknown["valid?"] == "unknown"


def test_es_rw_gen_shapes():
    test = {"concurrency": 6, "nodes": ["n1", "n2", "n3"]}
    g = port_elasticsearch.RWGen(2)
    ctx = port_gen.Context.for_test(test)
    writes, reads = [], []
    busy = []
    for i in range(12):
        if len(busy) == len(test["nodes"]) * 2:   # all 6 threads busy:
            for t in busy:                        # complete them all
                ctx = ctx.free(t)
            busy = []
        res = port_gen.op(g, test, ctx)
        assert res is not None
        op_, g = res
        assert op_ is not port_gen.PENDING
        thread = ctx.process_to_thread(op_["process"])
        ctx = ctx.with_time(op_["time"]).busy(thread)
        busy.append(thread)
        g = port_gen.update(g, test, ctx, op_)
        (writes if op_["f"] == "write" else reads).append(op_)
    assert writes and reads
    vals = [o["value"] for o in writes]
    assert vals == sorted(set(vals))
    assert all(isinstance(o["value"], int) for o in reads)


def test_es_rw_gen_tracks_node_by_thread_after_crash():
    test = {"concurrency": 5, "nodes": ["n1", "n2", "n3"]}
    g = port_elasticsearch.RWGen(2)
    ctx = port_gen.Context.for_test(test)
    ctx = ctx.with_worker(1, 6)
    ev = {"type": "invoke", "f": "write", "value": 42, "process": 6,
          "time": 0}
    g2 = port_gen.update(g, test, ctx, ev)
    assert g2.in_flight == (0, 42, 0)
    assert g2._node_of(ctx, 6, 3) == 1


def test_es_dirty_read_client_ops():
    with FakeESServer() as srv:
        test = {"db-hosts": fake_hosts(srv)}
        c = port_elasticsearch.DirtyReadClient().open(test, "n1")
        assert c.invoke(test, {"type": "invoke", "f": "write",
                               "value": 3})["type"] == "ok"
        assert c.invoke(test, {"type": "invoke", "f": "read",
                               "value": 3})["type"] == "ok"
        missing = c.invoke(test, {"type": "invoke", "f": "read",
                                  "value": 99})
        assert missing["type"] == "fail"
        assert c.invoke(test, {"type": "invoke", "f": "refresh"}
                        )["type"] == "ok"
        sr = c.invoke(test, {"type": "invoke", "f": "strong-read",
                             "value": None})
        assert sr["type"] == "ok" and sr["value"] == [3]


def test_es_dirty_read_end_to_end(tmp_path):
    with FakeESServer() as srv:
        test = run_suite(tmp_path, PORT,
                         port_elasticsearch.elasticsearch_test, srv,
                         {"workload": "dirty-read", "time-limit": 2.0,
                          "quiesce": 0.2, "concurrency": 6})
    r = test["results"]
    assert r["dirty-read"]["valid?"] is True, r
    assert r["dirty-read"]["strong-read-count"] >= 1


# ---------------------------------------------------------------------------
# The reference's cases: tests/test_template_suites.py (logcabin,
# charybdefs)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make_test,needle", [
    (port_logcabin.logcabin_test, "logcabin"),
    (port_charybdefs.charybdefs_test, "faultfs"),
])
def test_template_db_setup_against_dummy_remote(make_test, needle):
    test = make_test({"ssh": {"dummy": True}})
    port_control.on_nodes(test, lambda t, n: t["db"].setup(t, n))
    cmds = "\n".join(str(p) for _n, kind, p in test["remote"].actions
                     if kind in ("execute", "upload"))
    assert needle in cmds


@pytest.mark.parametrize("suite", ["crate", "logcabin", "elasticsearch",
                                   "charybdefs", "chronos"])
def test_every_suite_has_cli_and_workloads(suite):
    mod = port_suites.load_suite(suite)
    assert callable(mod.main)
    assert mod.workloads(), mod.__name__


def test_charybdefs_full_dummy_run(tmp_path):
    test = port_charybdefs.charybdefs_test({
        "ssh": {"dummy": True}, "time-limit": 1.0,
        "nodes": ["n1", "n2", "n3"], "concurrency": 3,
    })
    test["net"] = port_net.noop()
    test["store"] = PortStore(tmp_path / "store")
    test = port_core.run(test)
    r = test["results"]
    assert r["valid?"] is True, r
    assert r["stats"]["count"] > 0
    cmds = "\n".join(str(p) for _n, kind, p in test["remote"].actions
                     if kind == "execute")
    assert ".faultfs-ctl" in cmds


def test_suite_registry_loads_every_module():
    assert len(port_suites.SUITES) == 28
    for name in port_suites.SUITES:
        mod = port_suites.load_suite(name)
        assert callable(mod.main), name
        assert callable(mod.workloads), name
    with pytest.raises(ValueError):
        port_suites.load_suite("nope")


def test_logcabin_client_treeops_commands_and_cas_classification():
    test = port_logcabin.logcabin_test({"ssh": {"dummy": True},
                                        "nodes": ["n1", "n2"]})
    c = test["client"].open(test, "n1")
    assert c.invoke(test, {"type": "invoke", "f": "write", "value": 3,
                           "process": 0})["type"] == "ok"
    assert c.invoke(test, {"type": "invoke", "f": "cas", "value": [1, 2],
                           "process": 0})["type"] == "ok"
    r = c.invoke(test, {"type": "invoke", "f": "read", "value": None,
                        "process": 0})
    assert r["type"] == "ok" and r["value"] is None
    cmds = [p for _n, kind, p in test["remote"].actions
            if kind == "execute"]
    joined = "\n".join(cmds)
    assert "-p /r0:1" in joined
    assert "echo -n 2" in joined
    assert f"-t {port_logcabin.OP_TIMEOUT}" in joined

    class FailingRemote(port_control.DummyRemote):
        def __init__(self, err):
            super().__init__()
            self.errmsg = err

        def execute(self, spec, cmd, stdin=""):
            super().execute(spec, cmd, stdin)
            return port_control.Result("", self.errmsg, 1)

    def classify(f, value, err):
        t = dict(test)
        t["remote"] = FailingRemote(err)
        cl = port_logcabin.LogCabinClient("n1")
        return cl.invoke(t, {"type": "invoke", "f": f, "value": value,
                             "process": 0})

    cas_err = ("Exiting due to LogCabin::Client::Exception: Path "
               "'/r0' has value '3', not '1' as required")
    out = classify("cas", [1, 2], cas_err)
    assert out["type"] == "fail" and out["error"] == "cas-mismatch"
    to_err = ("Exiting due to LogCabin::Client::Exception: "
              "Client-specified timeout elapsed")
    assert classify("write", 3, to_err)["error"] == "timed-out"
    assert classify("write", 3, to_err)["type"] == "info"
    assert classify("read", None, to_err)["type"] == "fail"
    missing = ("Exiting due to LogCabin::Client::Exception: "
               "Path '/r0' does not exist")
    out = classify("read", None, missing)
    assert out["type"] == "ok" and out["value"] is None
    assert classify("write", 3, "boom")["type"] == "info"
    assert classify("read", None, "boom")["type"] == "fail"


# ---------------------------------------------------------------------------
# The checkers on seeded histories
# ---------------------------------------------------------------------------

def version_history(seed: int, n: int = 150) -> list:
    """Seeded reads of (value, _version) pairs (on odd seeds a few
    versions serving two values), unread rows and other ops among
    them."""
    rng = np.random.default_rng(seed)
    diverge = 0.03 if seed % 2 else 0.0
    out = []
    for _ in range(n):
        typ = ["ok", "ok", "ok", "fail", "info"][int(rng.integers(0, 5))]
        f = ["read", "read", "write"][int(rng.integers(0, 3))]
        kind = int(rng.integers(0, 6))
        if kind == 0:
            value = None
        elif kind == 1:
            value = {"value": int(rng.integers(0, 9))}
        else:
            ver = int(rng.integers(0, 12))
            # mostly the version's own value, now and then another
            val = ver * 10 if rng.random() >= diverge \
                else int(rng.integers(0, 120))
            value = {"value": val, "version": ver}
        out.append({"type": typ, "f": f, "value": value})
    return out


def dirty_read_history(seed: int, n: int = 120) -> list:
    """Seeded writes, reads and strong reads (one a node): an uncommitted
    read, a lost write or nodes that disagree now and then."""
    rng = np.random.default_rng(seed)
    committed = set(int(x) for x in rng.choice(40, 25, replace=False))
    out = []
    for _ in range(n):
        typ = ["ok", "ok", "fail", "info"][int(rng.integers(0, 4))]
        f = ["write", "read"][int(rng.integers(0, 2))]
        out.append({"type": typ, "f": f, "value": int(rng.integers(0, 45))})
    for _ in range(int(rng.integers(0, 4))):
        strong = set(committed)
        if rng.random() < 0.3:
            strong.discard(int(rng.integers(0, 40)))
        out.append({"type": "ok", "f": "strong-read",
                    "value": sorted(strong) if rng.random() < 0.9
                    else None})
    return out


@pytest.mark.parametrize("seed", range(10))
def test_multiversion_checker_equals_the_references(seed):
    hist = version_history(seed)
    ref = ref_crate.MultiVersionChecker().check({}, hist, {})
    port = port_crate.MultiVersionChecker().check({}, hist, {})
    assert port == ref
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)


@pytest.mark.parametrize("seed", range(10))
def test_dirty_read_checker_equals_the_references(seed):
    hist = dirty_read_history(seed)
    ref = ref_elasticsearch.DirtyReadChecker().check({}, hist, {})
    port = port_elasticsearch.DirtyReadChecker().check({}, hist, {})
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)


def test_seeded_histories_reach_every_verdict():
    """The seeds above give valid and invalid verdicts of both checkers,
    and an unknown dirty-read verdict."""
    mv = {port_crate.MultiVersionChecker().check(
        {}, version_history(s), {})["valid?"] for s in range(10)}
    dr = {port_elasticsearch.DirtyReadChecker().check(
        {}, dirty_read_history(s), {})["valid?"] for s in range(10)}
    assert mv == {True, False}
    assert {False, "unknown"} <= dr


# ---------------------------------------------------------------------------
# The clients
# ---------------------------------------------------------------------------

def test_crate_client_modes_op_for_op_with_the_references():
    """version-divergence reads and writes, lost-updates adds (insert,
    guarded update, a concurrent create) and reads, an unknown f, and a
    refused connection: the same completions from both packages."""
    got = {}
    for name, P in PKGS:
        out = {}
        kv = P["ind"].tuple_
        with FakePGServer() as srv:
            test = {"db-hosts": fake_hosts(srv)}
            c = P["crate"].CrateClient("version-divergence").open(test,
                                                                  "n1")
            out["vd"] = invoke_all(P, c, test, [
                ("read", kv(3, None)), ("write", kv(3, 5)),
                ("read", kv(3, None)), ("write", kv(3, 6)),
                ("read", kv(3, None)), ("read", None), ("frob", kv(3, 1))])
            c = P["crate"].CrateClient("lost-updates").open(test, "n2")
            out["lu"] = invoke_all(P, c, test, [
                ("read", kv(7, None)), ("add", kv(7, 1)), ("add", kv(7, 2)),
                ("add", kv(8, 3)), ("read", kv(7, None)),
                ("read", kv(8, None)), ("frob", kv(7, None))])
        refused = {"db-hosts": {"n1": ("127.0.0.1", 1)}}
        c = P["crate"].CrateClient("lost-updates").open(refused, "n1")
        out["refused"] = invoke_all(P, c, refused, [
            ("read", kv(1, None)), ("add", kv(1, 2))])
        got[name] = out
    # versions are the fake's own: compare their order, not their values
    assert got["port"] == got["ref"]
    vd = got["port"]["vd"]
    assert vd[0]["value"] == ["tuple", 3, None]
    assert vd[2]["value"][2]["value"] == 5
    assert vd[4]["value"][2]["version"] > vd[2]["value"][2]["version"]
    assert got["port"]["lu"][4]["value"] == ["tuple", 7, [1, 2]]
    assert [o["type"] for o in got["port"]["refused"]] == ["fail", "info"]


def es_ops() -> dict:
    return {"set": [("add", 3), ("add", 3), ("add", 5), ("read", None),
                    ("frob", None)],
            "dirty": [("write", 3), ("read", 3), ("read", 99),
                      ("refresh", None), ("strong-read", None),
                      ("frob", None)]}


def test_es_clients_op_for_op_with_the_references():
    """The set client (a create conflict is a definite fail) and the
    dirty-read client against FakeESServer, and both against a port
    nobody listens on."""
    got = {}
    for name, P in PKGS:
        out = {}
        es = P["elasticsearch"]
        with FakeESServer() as srv:
            test = {"db-hosts": fake_hosts(srv)}
            out["set"] = invoke_all(P, es.ESClient().open(test, "n1"), test,
                                    es_ops()["set"])
            out["dirty"] = invoke_all(P, 
                es.DirtyReadClient().open(test, "n2"), test,
                es_ops()["dirty"])
        refused = {"db-hosts": {"n1": ("127.0.0.1", 1)}}
        out["refused"] = invoke_all(P, 
            es.ESClient().open(refused, "n1"), refused,
            [("read", None), ("add", 1)]) + invoke_all(P, 
            es.DirtyReadClient().open(refused, "n1"), refused,
            [("strong-read", None), ("write", 1)])
        got[name] = out
    for o in got["ref"]["refused"] + got["port"]["refused"]:
        o["error"] = "refused" if "refused" in o["error"] else o["error"]
    assert got["port"] == got["ref"]
    assert [o["type"] for o in got["port"]["set"]] == [
        "ok", "fail", "ok", "ok", "fail"]
    assert got["port"]["set"][1]["error"] == "conflict"
    assert got["port"]["set"][3]["value"] == [3, 5]
    assert [o["type"] for o in got["port"]["refused"]] == [
        "fail", "info", "fail", "info"]


def treeops_ops() -> list:
    """A read of a never-written register, a cas on it, writes, reads,
    a cas that applies and one that does not, and an unknown f."""
    return [("read", 0), ("cas", [1, 2]), ("write", 3), ("read", 0),
            ("cas", [3, 4]), ("cas", [3, 1]), ("read", 0), ("frob", 0)]


def test_treeops_fake_answers_both_clients_alike():
    """The TreeOps remote (tests/fake_torch_treeops.py) answers the
    reference's client as it answers the port's: the same completions
    (the cas on a never-written path is indeterminate, as a failed
    conditional write is), the same commands, and the tree they leave."""
    got = {}
    for name, P in PKGS:
        with FakeTreeOpsRemote() as remote:
            test = {"nodes": ["n1", "n2"], "remote": remote}
            c = P["logcabin"].LogCabinClient().open(test, "n2")
            kv = P["ind"].tuple_
            ops = [(f, kv(k, None if f == "read" else v))
                   for f, v in treeops_ops() for k in (5,)]
            out = invoke_all(P, c, test, ops + [("write", 9), ("read", None)])
            for o in out:
                if o.get("error", "").startswith("command failed"):
                    o["error"] = o["error"].split(":")[0]
            got[name] = (out, sorted(remote.tree.items()),
                         [p for _n, k, p in remote.actions
                          if k == "execute"])
    assert got["port"] == got["ref"]
    out, tree, _cmds = got["port"]
    assert [o["type"] for o in out] == [
        "ok", "info", "ok", "ok", "ok", "fail", "ok", "fail", "ok", "ok"]
    assert out[0]["value"] == ["tuple", 5, None]
    assert out[3]["value"] == ["tuple", 5, 3]
    assert out[5]["error"] == "cas-mismatch"
    assert out[6]["value"] == ["tuple", 5, 4] and out[9]["value"] == 9
    assert tree == [("/r0", "9"), ("/r5", "4")]


def test_charybdefs_client_op_for_op_with_the_references():
    got = {}
    for name, P in PKGS:
        remote = P["control"].DummyRemote()
        remote.responses["cat /faulty/jepsen.log"] = "1\n2\n"
        test = {"nodes": ["n1"], "remote": remote}
        c = P["charybdefs"].FileClient().open(test, "n1")
        out = invoke_all(P, c, test, [("append", 1), ("read", None),
                                   ("frob", None)])
        got[name] = (out, [p for _n, k, p in remote.actions
                           if k == "execute"])
    assert got["port"] == got["ref"]
    assert got["port"][0][1]["value"] == [1, 2]


# ---------------------------------------------------------------------------
# Test maps, menus, generators and DB commands
# ---------------------------------------------------------------------------

#: the options each workload's test map is built with
MAP_OPTS = ({}, {"time-limit": 1}, {"device": "cpu"},
            {"faults": ["partition", "kill"]})


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_test_maps_and_menus_equal_the_references(suite):
    menu = sorted(PORT[suite].workloads({}))
    assert menu == sorted(REF[suite].workloads({}))
    make = SUITES[suite]
    cases = [{"workload": w, **o} for w in menu for o in MAP_OPTS] \
        if suite in ("crate", "elasticsearch") else list(MAP_OPTS)
    for opts in cases:
        ref = getattr(REF[suite], make)(copy.deepcopy(opts))
        port = getattr(PORT[suite], make)(copy.deepcopy(opts))
        assert map_shape(port) == map_shape(ref), opts
        assert port.get("nodes") == ref.get("nodes")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_register_checkers_take_the_device(device):
    """The one departure: logcabin's per-key register checker runs on
    opts' device (None: cuda); crate's register is standard_workloads'."""
    opts = {"device": device} if device else {}
    lc = port_logcabin.logcabin_test(opts)["checker"].sub
    cr = port_crate.crate_test({**opts, "workload": "register"})[
        "checker"].sub
    for lin in (lc, cr):
        assert type(lin).__name__ == "Linearizable" and lin.device == device


GENERATORS = {
    "crate-version-divergence": lambda P: P["crate"].version_divergence_gen(
        {"keys-concurrent": 2, "readers": 1, "key-count": 5}),
    "logcabin-register": lambda P: P["logcabin"].workloads({})[
        "register"]()["generator"],
    "charybdefs": lambda P: P["charybdefs"].generator(),
    "elasticsearch-set": lambda P: P["elasticsearch"].workloads({})[
        "set"]()["generator"],
}


@pytest.mark.parametrize("which", sorted(GENERATORS))
def test_generators_draw_as_the_references(which):
    """Each workload's ops under the same `random` seed, through the
    generator simulation: op for op the reference's."""
    got = {}
    for name, P in PKGS:
        random.seed(23)
        g = P["gen"].limit(300, GENERATORS[which](P))
        got[name] = plain(simulate(P["gen"], g, perfect, concurrency=4))
    assert got["port"] == got["ref"]
    assert [o for o in got["port"] if o["type"] == "invoke"]


def db_commands(P, suite: str, nodes: list) -> list:
    """The suite's OS and DB setup and teardown on the dummy remote,
    node by node; an upload as its remote path and its file's bytes.
    Each package's memo of node IPs is cleared first, so both look
    them up."""
    import importlib
    importlib.import_module(
        f"{P['control'].__name__}.net").clear_ip_cache()
    test = getattr(P[suite], SUITES[suite])(
        {"ssh": {"dummy": True}, "nodes": nodes})

    def lifecycle(t, n):
        if t.get("os") is not None:
            t["os"].setup(t, n)
        t["db"].setup(t, n)
        t["db"].teardown(t, n)

    P["control"].on_nodes(test, lifecycle)
    out = []
    for n, k, p in test["remote"].actions:
        if k == "upload":
            p = (Path(p[0]).read_bytes(), p[1])
        out.append((n, k, str(p)))
    return sorted(out)


@pytest.mark.parametrize("suite,needle", [
    ("crate", "crate"), ("logcabin", "LogCabin"),
    ("elasticsearch", "elasticsearch"), ("charybdefs", "faultfs")])
def test_db_setup_commands_as_the_references(suite, needle, monkeypatch):
    import time
    monkeypatch.setattr(time, "sleep", lambda s: None)
    nodes = ["n1", "n2", "n3"]
    ref = db_commands(REF, suite, nodes)
    port = db_commands(PORT, suite, nodes)
    assert port == ref
    assert any(needle in p for _n, k, p in port if k == "execute")


# ---------------------------------------------------------------------------
# End to end through each suite's main
# ---------------------------------------------------------------------------

#: name -> (suite, fake (None: the dummy remote), --workload or None,
#: extra opts, concurrency)
RUNS = {
    "crate-register": ("crate", FakePGServer, "register", {}, 4),
    "crate-wr": ("crate", FakePGServer, "wr", {}, 5),
    "crate-version-divergence": ("crate", FakePGServer,
                                 "version-divergence",
                                 {"keys-concurrent": 4, "readers": 2}, 5),
    "crate-lost-updates": ("crate", FakePGServer, "lost-updates",
                           {"time-limit": 3.0, "quiesce": 0.5,
                            "keys-concurrent": 4, "key-count": 2}, 5),
    "logcabin-register": ("logcabin", FakeTreeOpsRemote, None, {}, 4),
    # 50 adds: the set is read well inside the limit under any load
    "elasticsearch-set": ("elasticsearch", FakeESServer, "set",
                          {"set-size": 50}, 5),
    "elasticsearch-dirty-read": ("elasticsearch", FakeESServer,
                                 "dirty-read", {"quiesce": 0.2}, 6),
    "charybdefs-file-faults": ("charybdefs", None, None, {}, 3),
}
#: the runs whose results compose plots, run a second time without
#: matplotlib
NO_MPL = ("elasticsearch-set",)


def main_run(which: str, tmp_path: Path, monkeypatch,
             device=("--device", "cpu")):
    """The suite's own main against its fake, 2.5 s, the partitioner
    every 0.3 s; returns (exit code, JSON lines, the remote)."""
    suite, fake, workload, extra, conc = RUNS[which]
    argv = ["test", "--dummy", *device, "--store",
            str(tmp_path / "port"), "--concurrency", str(conc)]
    if workload:
        argv += ["--workload", workload]
    ctx = fake() if fake is not None else contextlib.nullcontext()
    with ctx as srv:
        remote = srv if isinstance(srv, port_control.Remote) \
            else port_control.DummyRemote()
        hosts = fake_hosts(srv) if getattr(srv, "port", None) else {}
        rc, lines = run_main(
            monkeypatch, PORT[suite], SUITES[suite],
            {"db-hosts": hosts, "time-limit": 2.5,
             "nemesis-interval": 0.3, **extra}, argv, remote)
    return rc, lines, remote


def checker_for(P, which: str):
    suite, _fake, workload, extra, _conc = RUNS[which]
    return getattr(P[suite], SUITES[suite])(
        {**extra, **({"workload": workload} if workload else {})})[
        "checker"]


@pytest.mark.parametrize("which,mpl", [
    *[(w, True) for w in sorted(RUNS)],
    *[(w, False) for w in NO_MPL]],
    ids=lambda x: x if isinstance(x, str) else ("mpl" if x else "no-mpl"))
def test_suite_main_equals_the_reference(which, mpl, tmp_path,
                                         reference_env, monkeypatch):
    """The suite's `main` (`test --dummy --device cpu [--workload W]`)
    against its fake; the two packages' re-checks of the stored run, in
    turn on one path, give the same results (per key for registers) and
    files; without matplotlib the plot entries are unknown in both and
    the run exits 2."""
    if not mpl:
        block_matplotlib(monkeypatch)
    suite, _fake, workload, _extra, _conc = RUNS[which]
    before = set(threading.enumerate())
    rc, lines, remote = main_run(which, tmp_path, monkeypatch)
    assert no_workers_left() and no_threads_left(before)
    assert len(lines) == 1
    run = Path(lines[0]["dir"])
    res = json.loads((run / "results.json").read_text())
    want = True if mpl or "perf" not in res else "unknown"
    assert lines[0]["valid?"] == res["valid?"] == want, res
    assert rc == (0 if want is True else 2)
    hist = [json.loads(ln) for ln in
            (run / "history.jsonl").read_text().splitlines()]
    client_ops = [o for o in hist if isinstance(o["process"], int)]
    assert client_ops
    if suite != "charybdefs":
        assert {o["f"] for o in hist if o["process"] == "nemesis"} <= {
            "start", "stop"}
        assert any("iptables" in str(p) for _n, k, p in remote.actions
                   if k == "execute")
    stored = json.loads((run / "test.json").read_text())
    assert stored["device"] == "cpu"
    out = recheck_in_turn(run, tmp_path,
                          lambda P: checker_for(P, which), monkeypatch,
                          pkgs=(REF, PORT))
    if mpl:
        got = same_recheck(out)
    else:
        (rrc, rres, rfiles), (prc, pres, pfiles) = out["ref"], out["port"]
        assert prc == rrc == 2
        assert strip_plot_errors(pres) == strip_plot_errors(rres)
        assert pres["perf"]["valid?"] == "unknown"
        assert not [f for f in pfiles if f.endswith(".png")]
        assert sorted(pfiles) == sorted(rfiles)
        got = pres
    assert got["valid?"] == res["valid?"]
    name = workload or {"logcabin": "register"}.get(suite)
    if name == "register":
        keys = per_key(res)
        assert keys and all(v is True for v in keys.values())
        assert per_key(got) == keys
        assert {r["analyzer"] for r in res["results"].values()} == {
            "tpu-dense"}
    if name == "wr":
        assert res["valid?"] is True
    if name == "set":
        assert res["set"]["ok-count"] == 50 and res["set"]["lost-count"] == 0
    if name == "dirty-read":
        assert res["dirty-read"]["valid?"] is True
        assert res["dirty-read"]["strong-read-count"] >= 1
    if suite == "charybdefs":
        assert res["stats"]["count"] > 0


@pytest.mark.parametrize("which", ["crate-register", "logcabin-register"])
def test_suite_main_without_a_card_exits_255(which, tmp_path, monkeypatch,
                                             capsys):
    """Without --device the checker is the device path: no card here,
    so DeviceUnavailable and exit 255, the history stored and no
    verdict."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines, _ = main_run(which, tmp_path, monkeypatch, device=())
    assert rc == 255 and not lines
    assert "no CUDA device is available" in capsys.readouterr().err
    runs = [p.parent for p in (tmp_path / "port").rglob("history.jsonl")]
    assert len(runs) == 1 and not (runs[0] / "results.json").exists()

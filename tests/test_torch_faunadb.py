"""The port's `faunadb` suite over its own wire driver
(`drivers/fauna_http.py`), with `util.iso_to_epoch`, against the
reference's.

- The reference's own cases (tests/test_fauna_client.py,
  tests/test_fauna_pages_mm.py and the faunadb cases of
  tests/test_template_suites.py) on the port's copies, against
  tests/fake_fauna.py (standard library only).
- The driver byte for byte: the FQL wire JSON of every constructor, the
  request bytes a session sends to the fake, the decoding of tagged
  replies, and each package's reading of scripted HTTP replies: the
  same values, and the same `DBError` or `DriverError`, with the same
  `is_retriable`.
- The client op for op in every mode against the fake, a refused
  connection included.
- The checkers (pages, timestamp order, read skew with its own Tarjan,
  internal consistency) and the timestamp key on seeded inputs; the
  replica-aware grudges under a seeded `random`; the topology nemesis's
  commands.
- The test maps, workload and nemesis menus, generators (under a seeded
  `random`) and the DB setup commands on a dummy remote.
- End to end: `main(["test", "--dummy", "--device", "cpu", "--workload",
  W])` against the fake for every workload; both packages' `analyze
  --backend cpu` of the stored run, in turn on one path, give the same
  results (per key for registers) and the same files.
"""

import contextlib
import copy
import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

import jepsen_tpu.control as ref_control
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.nemesis as ref_nemesis
import jepsen_tpu.suites.faunadb as ref_faunadb
import jepsen_tpu.util as ref_util
from jepsen_tpu import drivers as ref_drivers
from jepsen_tpu.drivers import fauna_http as ref_q
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.nemesis as port_nemesis
import jepsen_tpu_torch.suites.faunadb as port_faunadb
import jepsen_tpu_torch.util as port_util
from jepsen_tpu_torch import core as port_core
from jepsen_tpu_torch import drivers as port_drivers
from jepsen_tpu_torch import net as port_net
from jepsen_tpu_torch.drivers import DBError as PortDBError
from jepsen_tpu_torch.drivers import fauna_http as port_q
from jepsen_tpu_torch.store import Store as PortStore

from fake_fauna import FakeFaunaServer
from test_torch_baseline_suites import (fake_hosts, map_shape,
                                        no_threads_left, per_key, plain,
                                        recheck_in_turn, run_main,
                                        same_recheck)
from test_torch_cli import reference_env  # noqa: F401
from test_torch_core_run import no_workers_left
from test_torch_generator import perfect, simulate
from test_torch_more_suites import recorded  # noqa: F401
from test_torch_queue_suites import outcome

REF = dict(ind=ref_ind, gen=ref_gen, control=ref_control,
           nemesis=ref_nemesis, drivers=ref_drivers, q=ref_q,
           faunadb=ref_faunadb, util=ref_util)
PORT = dict(ind=port_ind, gen=port_gen, control=port_control,
            nemesis=port_nemesis, drivers=port_drivers, q=port_q,
            faunadb=port_faunadb, util=port_util)
PKGS = (("ref", REF), ("port", PORT))


def canon(x):
    """A value as plain data: independent tuples as [key, value] lists,
    either package's `Ref` as ("Ref", id, its class), sets as sorted
    lists, for comparing the two packages' results."""
    if type(x).__name__ == "Ref" and hasattr(x, "cls"):
        return ("Ref", x.id, canon(x.cls))
    if isinstance(x, (set, frozenset)):
        return sorted(canon(v) for v in x)
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        if hasattr(x, "key") and hasattr(x, "value"):
            return ["tuple", canon(x.key), canon(x.value)]
        return [canon(v) for v in x]
    return x


def hosts_for(srv):
    return {n: ("127.0.0.1", srv.port)
            for n in ("n1", "n2", "n3", "n4", "n5")}


# ---------------------------------------------------------------------------
# The reference's cases on the port's copies: tests/test_fauna_client.py
# ---------------------------------------------------------------------------

def test_driver_crud_roundtrip():
    q = port_q
    with FakeFaunaServer() as srv:
        c = q.connect("127.0.0.1", srv.port)
        c.query(q.create_class({"name": "test"}))
        assert c.query(q.exists(q.class_("test"))) is True
        ref = q.ref_(q.class_("test"), 1)
        c.query(q.create(ref, {"data": {"register": 3}}))
        doc = c.query(q.get_(ref))
        assert doc["data"]["register"] == 3
        assert isinstance(doc["ref"], q.Ref) and doc["ref"].id == "1"
        c.query(q.update(ref, {"data": {"register": 4}}))
        assert c.query(q.select(["data", "register"], q.get_(ref))) == 4
        with pytest.raises(PortDBError) as ei:
            c.query(q.get_(q.ref_(q.class_("test"), 99)))
        assert ei.value.code == "instance not found"


def test_driver_abort_rolls_back():
    q = port_q
    with FakeFaunaServer() as srv:
        c = q.connect("127.0.0.1", srv.port)
        c.query(q.create_class({"name": "t"}))
        ref = q.ref_(q.class_("t"), 1)
        c.query(q.create(ref, {"data": {"v": 1}}))
        with pytest.raises(PortDBError) as ei:
            c.query(q.do(q.update(ref, {"data": {"v": 9}}),
                         q.abort("nope")))
        assert ei.value.code == "transaction aborted"
        # the update inside the aborted query must not be visible
        assert c.query(q.select(["data", "v"], q.get_(ref))) == 1


def test_client_register_cas():
    kv = port_ind.tuple_
    with FakeFaunaServer() as srv:
        test = {"db-hosts": hosts_for(srv)}
        c = port_faunadb.FaunaClient("register").open(test, "n1")
        assert c.invoke(test, {"type": "invoke", "f": "write",
                               "value": kv(2, 3), "process": 0})[
            "type"] == "ok"
        r = c.invoke(test, {"type": "invoke", "f": "read",
                            "value": kv(2, None), "process": 0})
        assert r["type"] == "ok" and r["value"].value == 3
        ok = c.invoke(test, {"type": "invoke", "f": "cas",
                             "value": kv(2, [3, 4]), "process": 0})
        assert ok["type"] == "ok"
        miss = c.invoke(test, {"type": "invoke", "f": "cas",
                               "value": kv(2, [3, 5]), "process": 0})
        assert miss["type"] == "fail"
        # unwritten key reads nil
        r0 = c.invoke(test, {"type": "invoke", "f": "read",
                             "value": kv(7, None), "process": 0})
        assert r0["type"] == "ok" and r0["value"].value is None


def test_client_set_add_read():
    with FakeFaunaServer() as srv:
        test = {"db-hosts": hosts_for(srv)}
        c = port_faunadb.FaunaClient("set").open(test, "n1")
        for v in (1, 5, 9):
            assert c.invoke(test, {"type": "invoke", "f": "add",
                                   "value": v,
                                   "process": 0})["type"] == "ok"
        r = c.invoke(test, {"type": "invoke", "f": "read", "value": None,
                            "process": 0})
        assert r["type"] == "ok" and r["value"] == {1, 5, 9}


def test_client_bank_transfer_and_abort():
    with FakeFaunaServer() as srv:
        test = {"db-hosts": hosts_for(srv)}
        c = port_faunadb.FaunaClient("bank").open(test, "n1")
        r = c.invoke(test, {"type": "invoke", "f": "read", "value": None,
                            "process": 0})
        assert sum(r["value"].values()) == 100
        t = c.invoke(test, {"type": "invoke", "f": "transfer",
                            "process": 0,
                            "value": {"from": 0, "to": 3, "amount": 30}})
        assert t["type"] == "ok"
        # overdraw: bank.clj's abort path -> definite :fail :negative
        bad = c.invoke(test, {"type": "invoke", "f": "transfer",
                              "process": 0,
                              "value": {"from": 3, "to": 0,
                                        "amount": 31}})
        assert bad["type"] == "fail" and bad["error"] == "negative"
        r = c.invoke(test, {"type": "invoke", "f": "read", "value": None,
                            "process": 0})
        assert sum(r["value"].values()) == 100 and r["value"][3] == 30


def test_client_monotonic_inc():
    with FakeFaunaServer() as srv:
        test = {"db-hosts": hosts_for(srv)}
        c = port_faunadb.FaunaClient("monotonic").open(test, "n1")
        assert c.invoke(test, {"type": "invoke", "f": "read",
                               "value": None,
                               "process": 0})["value"] == 0
        vals = [c.invoke(test, {"type": "invoke", "f": "inc",
                                "value": None, "process": 0})["value"]
                for _ in range(3)]
        assert vals == [1, 2, 3]


def test_client_g2_at_most_one_insert_per_key():
    kv = port_ind.tuple_
    with FakeFaunaServer() as srv:
        test = {"db-hosts": hosts_for(srv)}
        c = port_faunadb.FaunaClient("g2").open(test, "n1")
        first = c.invoke(test, {"type": "invoke", "f": "insert",
                                "process": 0, "value": kv(1, [5, None])})
        assert first["type"] == "ok"
        second = c.invoke(test, {"type": "invoke", "f": "insert",
                                 "process": 0, "value": kv(1, [None, 6])})
        assert second["type"] == "fail"
        other = c.invoke(test, {"type": "invoke", "f": "insert",
                                "process": 0, "value": kv(2, [None, 7])})
        assert other["type"] == "ok"


def test_faunadb_suite_end_to_end(tmp_path):
    # The set workload's 100 adds and its final read must all land
    # inside the time limit, or the set is never read and the verdict is
    # unknown: 1 s held only while the machine was idle. The run lasts
    # about 10 s whatever the limit up to 10 s (it ends at the nemesis
    # schedule's first op, after its 10 s sleep), so a 10 s limit costs
    # no time and leaves the adds ten times the room.
    with FakeFaunaServer() as srv:
        opts = {
            "workload": "set",
            "ssh": {"dummy": True}, "time-limit": 10.0,
            "extra": {"net": port_net.noop(),
                      "store": PortStore(tmp_path / "store")},
            "db-hosts": hosts_for(srv),
        }
        test = port_faunadb.faunadb_test(opts)
        for k in ("db", "os", "nemesis"):
            test.pop(k, None)
        test = port_core.run(test)
    r = test["results"]
    assert r["valid?"] is True, r


# ---------------------------------------------------------------------------
# The reference's cases on the port's copies: tests/test_fauna_pages_mm.py
# ---------------------------------------------------------------------------

def test_pages_client_group_add_and_read():
    kv = port_ind.tuple_
    with FakeFaunaServer() as srv:
        test = {"db-hosts": hosts_for(srv)}
        c = port_faunadb.FaunaClient("pages").open(test, "n1")
        out = c.invoke(test, {"type": "invoke", "f": "add",
                              "value": kv(1, [1, 5, -15, 23])})
        assert out["type"] == "ok"
        out = c.invoke(test, {"type": "invoke", "f": "add",
                              "value": kv(1, [2, 7])})
        assert out["type"] == "ok"
        # another key's elements are invisible to key 1
        assert c.invoke(test, {"type": "invoke", "f": "add",
                               "value": kv(2, [100])})["type"] == "ok"
        r = c.invoke(test, {"type": "invoke", "f": "read",
                            "value": kv(1, None)})
        assert r["type"] == "ok"
        assert sorted(r["value"].value) == [-15, 1, 2, 5, 7, 23]


def test_pages_checker_golden():
    def op(ty, f, v, i):
        return {"type": ty, "f": f, "value": v, "index": i}
    # add [1,2] and [3,4]; a read seeing {1,2,3,4} is fine, {1,3,4} is
    # a pagination-isolation violation (1 without 2)
    base = [op("invoke", "add", [1, 2], 0), op("ok", "add", [1, 2], 1),
            op("invoke", "add", [3, 4], 2), op("ok", "add", [3, 4], 3)]
    good = base + [op("invoke", "read", None, 4),
                   op("ok", "read", [1, 2, 3, 4], 5)]
    bad = base + [op("invoke", "read", None, 4),
                  op("ok", "read", [1, 3, 4], 5)]
    chk = port_faunadb.PagesChecker()
    assert chk.check({}, good, {})["valid?"] is True
    res = chk.check({}, bad, {})
    assert res["valid?"] is False
    assert res["first-error"]["expected"] == [1, 2]
    # a failed add never constrains reads
    failed = [op("invoke", "add", [8, 9], 0), op("fail", "add", [8, 9], 1),
              op("invoke", "read", None, 2), op("ok", "read", [], 3)]
    assert chk.check({}, failed, {})["valid?"] is True


def test_pages_workload_full_run(tmp_path):
    with FakeFaunaServer() as srv:
        wl = port_faunadb._pages_workload({"nodes": ["n1"],
                                           "pages-ops-per-key": 30,
                                           "pages-elements": 40})
        t = {"name": "fauna pages", "nodes": ["n1", "n2", "n3"],
             "concurrency": 4, "ssh": {"dummy": True},
             "db-hosts": hosts_for(srv),
             "client": wl["client"], "checker": wl["checker"],
             "generator": port_gen.time_limit(
                 3, port_gen.clients(wl["generator"])),
             "store": PortStore(tmp_path / "store")}
        t = port_core.run(t)
        assert t["results"]["valid?"] is True
        reads = [o for o in t["history"]
                 if o.get("type") == "ok" and o.get("f") == "read"]
        assert reads


def test_mm_client_write_read():
    with FakeFaunaServer() as srv:
        test = {"db-hosts": hosts_for(srv)}
        c = port_faunadb.FaunaClient("multimonotonic").open(test, "n1")
        assert c.invoke(test, {"type": "invoke", "f": "write",
                               "value": {3: 0, 4: 10}})["type"] == "ok"
        assert c.invoke(test, {"type": "invoke", "f": "write",
                               "value": {3: 1}})["type"] == "ok"
        r = c.invoke(test, {"type": "invoke", "f": "read",
                            "value": [3, 4, 9]})
        assert r["type"] == "ok"
        v = r["value"]
        assert v["ts"] is not None
        assert v["registers"][3]["value"] == 1
        assert v["registers"][4]["value"] == 10
        assert 9 not in v["registers"]
        # instance ts present and ordered
        assert v["registers"][3]["ts"] is not None


def _read_op(ts, regs, i):
    return {"type": "ok", "f": "read", "index": i,
            "value": {"ts": ts,
                      "registers": {k: {"ts": None, "value": v}
                                    for k, v in regs.items()}}}


def test_ts_order_checker_golden():
    chk = port_faunadb.TsOrderChecker()
    good = [_read_op("t1", {0: 1}, 0), _read_op("t2", {0: 2}, 1)]
    assert chk.check({}, good, {})["valid?"] is True
    # later timestamp, lower value: nonmonotonic
    bad = [_read_op("t1", {0: 2}, 0), _read_op("t2", {0: 1}, 1)]
    res = chk.check({}, bad, {})
    assert res["valid?"] is False and res["error-count"] == 1


def test_ts_sort_key_fractional_seconds():
    key = port_faunadb._ts_sort_key
    ts = ["2026-01-01T10:00:00.5Z", "2026-01-01T10:00:00Z",
          "2026-01-01T10:00:01Z"]
    assert sorted(ts) != ts[1:2] + ts[:1] + ts[2:]  # lexicographic wrong
    assert sorted(ts, key=key) == [ts[1], ts[0], ts[2]]
    # numeric (microsecond-int) timestamps still sort
    assert sorted([3, 1, 2], key=key) == [1, 2, 3]
    # raw microsecond ints and decoded ISO strings order by actual
    # time when one history mixes both forms
    mixed = [1_700_000_000_500_000, "2023-11-14T22:13:20+00:00"]
    assert sorted(mixed, key=key) == \
        ["2023-11-14T22:13:20+00:00", 1_700_000_000_500_000]


def test_ts_order_checker_mixed_precision_not_false_positive():
    # value 1 at 10:00:00Z, value 2 half a second later: monotonic —
    # but lexicographic ordering would reverse the reads and flag it
    good = [_read_op("2026-01-01T10:00:00.5Z", {0: 2}, 1),
            _read_op("2026-01-01T10:00:00Z", {0: 1}, 0)]
    assert port_faunadb.TsOrderChecker().check({}, good, {})["valid?"] \
        is True


def test_read_skew_checker_golden():
    chk = port_faunadb.ReadSkewChecker()
    # r1 sees x=1,y=2; r2 sees x=2,y=1: each is in the other's future
    bad = [_read_op("t1", {"x": 1, "y": 2}, 0),
           _read_op("t2", {"x": 2, "y": 1}, 1)]
    res = chk.check({}, bad, {})
    assert res["valid?"] is False
    assert res["errors"][0]["cycle-reads"] == [0, 1]
    good = [_read_op("t1", {"x": 1, "y": 1}, 0),
            _read_op("t2", {"x": 2, "y": 2}, 1)]
    assert chk.check({}, good, {})["valid?"] is True


def test_mm_workload_full_run(tmp_path):
    with FakeFaunaServer() as srv:
        wl = port_faunadb._mm_workload({"concurrency": 4})
        t = {"name": "fauna mm", "nodes": ["n1", "n2", "n3"],
             "concurrency": 4, "ssh": {"dummy": True},
             "db-hosts": hosts_for(srv),
             "client": wl["client"], "checker": wl["checker"],
             "generator": port_gen.time_limit(
                 2, port_gen.clients(wl["generator"])),
             "store": PortStore(tmp_path / "store")}
        t = port_core.run(t)
        assert t["results"]["valid?"] is True, t["results"]
        writes = [o for o in t["history"]
                  if o.get("type") == "ok" and o.get("f") == "write"]
        reads = [o for o in t["history"]
                 if o.get("type") == "ok" and o.get("f") == "read"]
        assert writes and reads


def test_topology_nemesis_ops():
    test = {"nodes": ["n1", "n2", "n3", "n4", "n5"],
            "ssh": {"dummy": True}}
    remote = port_control.remote_for(test)
    nem = port_faunadb.TopologyNemesis().setup(test)
    out = nem.invoke(test, {"type": "info", "f": "remove-node"})
    assert out["value"] == "n5"
    cmds = " || ".join(str(p) for _, k, p in remote.actions
                       if k == "execute")
    assert "faunadb-admin remove" in cmds and "host-id n5" in cmds
    remote.actions.clear()
    out = nem.invoke(test, {"type": "info", "f": "add-node"})
    assert out["value"] == "n5"
    cmds = " || ".join(str(p) for _, k, p in remote.actions
                       if k == "execute")
    assert "join" in cmds
    # removal floor: never removes below a majority + 1
    nem2 = port_faunadb.TopologyNemesis().setup(test)
    removed = [nem2.invoke(test, {"type": "info", "f": "remove-node"})
               for _ in range(5)]
    assert [o["value"] for o in removed[:2]] == ["n5", "n4"]
    assert all(o["value"] == "too-few" for o in removed[2:])


def test_topology_nemesis_selected_by_opts():
    t = port_faunadb.faunadb_test({"nemesis": "topology", "time-limit": 1})
    assert isinstance(t["nemesis"], port_faunadb.TopologyNemesis)
    assert "pages" in port_faunadb.workloads() \
        and "multimonotonic" in port_faunadb.workloads()


def test_replica_aware_grudges():
    nodes = [f"n{i}" for i in range(1, 10)]  # 9 nodes, 3 replicas
    by_rep = port_faunadb.nodes_by_replica(nodes, 3)
    assert by_rep["replica-0"] == ["n1", "n4", "n7"]
    assert by_rep["replica-2"] == ["n3", "n6", "n9"]

    # intra-replica: only members of ONE replica appear in the grudge
    g = port_faunadb.intra_replica_grudge(3)(nodes)
    cut = set(g)
    reps = {r for r, ms in by_rep.items() if cut & set(ms)}
    assert len(reps) == 1
    for n, blocked in g.items():
        assert set(blocked) <= set(by_rep[next(iter(reps))])

    # inter-replica: every node is cut from SOME other replica's nodes,
    # and no node is cut from a member of its own replica
    g = port_faunadb.inter_replica_grudge(3)(nodes)
    assert set(g) == set(nodes)
    rep_of = {n: r for r, ms in by_rep.items() for n in ms}
    for n, blocked in g.items():
        assert blocked, n
        assert all(rep_of[b] != rep_of[n] for b in blocked)

    # single node: one loner cut from all, all cut from the loner
    g = port_faunadb.single_node_grudge(nodes)
    loner = [n for n, b in g.items() if len(b) == len(nodes) - 1]
    assert len(loner) == 1
    for n, b in g.items():
        if n != loner[0]:
            assert b == [loner[0]] or set(b) == {loner[0]}


def test_fauna_nemesis_menu_selects():
    for name in ("single-node-partition", "intra-replica-partition",
                 "inter-replica-partition"):
        t = port_faunadb.faunadb_test({"nemesis": name, "time-limit": 1})
        assert isinstance(t["nemesis"], port_nemesis.Partitioner), name


def test_internal_client_create_variants():
    with FakeFaunaServer() as srv:
        test = {"db-hosts": hosts_for(srv)}
        c = port_faunadb.FaunaClient("internal").open(test, "n1")
        for i, f in enumerate(("create-tabby-let", "create-tabby-obj",
                               "create-tabby-arr")):
            out = c.invoke(test, {"type": "invoke", "f": f, "value": i})
            assert out["type"] == "ok", out
            v = out["value"]
            name = v["tabby"]["data"]["name"]
            assert name == i
            # the txn's own create is invisible before, visible after
            assert name not in v["tabbies-0"]
            assert name in v["tabbies-1"]
            # earlier cats visible in both reads
            for prev in range(i):
                assert prev in v["tabbies-0"] and prev in v["tabbies-1"]


def test_internal_client_change_type_and_reset():
    with FakeFaunaServer() as srv:
        test = {"db-hosts": hosts_for(srv)}
        c = port_faunadb.FaunaClient("internal").open(test, "n1")
        c.invoke(test, {"type": "invoke", "f": "create-tabby-let",
                        "value": 7})
        out = c.invoke(test, {"type": "invoke", "f": "change-type",
                              "value": None})
        assert out["type"] == "ok"
        v = out["value"]
        assert v["cat"]["data"]["name"] == 7
        assert 7 not in v["tabbies"]
        assert 7 in v["calicos"]
        # change-type with no tabbies left: cat is None, no error
        out2 = c.invoke(test, {"type": "invoke", "f": "change-type",
                               "value": None})
        assert out2["type"] == "ok" and out2["value"]["cat"] is None
        assert c.invoke(test, {"type": "invoke", "f": "reset",
                               "value": None})["type"] == "ok"
        out3 = c.invoke(test, {"type": "invoke", "f": "change-type",
                               "value": None})
        assert out3["value"]["calicos"] == []


def test_internal_checker_golden():
    chk = port_faunadb.InternalChecker()

    def op(f, v, i=0):
        return {"type": "ok", "f": f, "value": v, "index": i}
    good = op("create-tabby-let",
              {"tabbies-0": [1], "tabby": {"data": {"name": 2}},
               "tabbies-1": [1, 2]})
    assert chk.check({}, [good], {})["valid?"] is True
    bad1 = op("create-tabby-obj",
              {"tabbies-0": [2], "tabby": {"data": {"name": 2}},
               "tabbies-1": [2]})
    res = chk.check({}, [bad1], {})
    assert res["valid?"] is False
    assert res["error-types"] == ["present-before-create"]
    bad2 = op("create-tabby-arr",
              {"tabbies-0": [], "tabby": {"data": {"name": 2}},
               "tabbies-1": []})
    assert chk.check({}, [bad2], {})["error-types"] == \
        ["missing-after-create"]
    bad3 = op("change-type",
              {"cat": {"data": {"name": 5}}, "tabbies": [5],
               "calicos": []})
    assert sorted(chk.check({}, [bad3], {})["error-types"]) == \
        ["missing-after-change", "present-after-change"]


def test_internal_workload_full_run(tmp_path):
    with FakeFaunaServer() as srv:
        wl = port_faunadb._internal_workload({})
        t = {"name": "fauna internal", "nodes": ["n1", "n2", "n3"],
             "concurrency": 3, "ssh": {"dummy": True},
             "db-hosts": hosts_for(srv),
             "client": wl["client"], "checker": wl["checker"],
             "generator": port_gen.time_limit(
                 2, port_gen.clients(wl["generator"])),
             "store": PortStore(tmp_path / "store")}
        t = port_core.run(t)
        assert t["results"]["valid?"] is True, t["results"]
        oks = [o for o in t["history"] if o.get("type") == "ok"]
        assert any(o["f"].startswith("create-tabby") for o in oks)


# the faunadb cases of tests/test_template_suites.py

def test_db_setup_against_dummy_remote():
    test = port_faunadb.faunadb_test({"ssh": {"dummy": True}})
    port_control.on_nodes(test, lambda t, n: t["db"].setup(t, n))
    cmds = "\n".join(str(p) for _n, kind, p in test["remote"].actions
                     if kind in ("execute", "upload"))
    assert "faunadb" in cmds


def test_suite_has_cli_and_workloads():
    assert callable(port_faunadb.main)
    assert port_faunadb.workloads()


# ---------------------------------------------------------------------------
# iso_to_epoch and the timestamp key
# ---------------------------------------------------------------------------

ISO_CASES = [
    "1970-01-01T00:00:00.000000001Z", "1970-01-01T00:00:00.123456789Z",
    "2026-01-01T10:00:00.5Z", "2026-01-01T10:00:00Z",
    "2026-01-01T10:00:00,25+02:00", "2026-01-01T10:00:00.1-05:30",
    "2026-01-01T10:00:00", "2026-01-01T10:00:00.999999999",
    "2026-01-01 10:00:00.7", "2026-01-01",
    "2023-11-14T22:13:20+00:00", "not a time", "2026-13-01T00:00:00Z",
    "t1", "",
]


def iso_outcome(util, s):
    try:
        return ("ok", util.iso_to_epoch(s))
    except ValueError as e:
        return ("value-error", str(e))


@pytest.mark.parametrize("tz", ["UTC", "America/Los_Angeles",
                                "Asia/Kolkata"])
def test_iso_to_epoch_equals_the_references(tz, monkeypatch):
    """Nine-digit fractions, comma fractions, offsets and naive local
    times (under three zones): the reference's floats, bit for bit, and
    the same ValueError for what does not parse."""
    import time
    monkeypatch.setenv("TZ", tz)
    time.tzset()
    try:
        rng = random.Random(tz)
        cases = ISO_CASES + [
            f"20{rng.randrange(10, 40)}-{rng.randrange(1, 13):02d}-"
            f"{rng.randrange(1, 29):02d}T{rng.randrange(24):02d}:"
            f"{rng.randrange(60):02d}:{rng.randrange(60):02d}"
            f"{rng.choice(['.', ','])}{rng.randrange(10 ** 9):09d}"
            f"{rng.choice(['Z', '+01:00', '-07:00', ''])}"
            for _ in range(200)]
        for s in cases:
            assert iso_outcome(port_util, s) == iso_outcome(ref_util, s), s
        for ts in cases + [0, 3, 1.5, 1_700_000_000_500_000,
                           1_700_000_000_500, 10 ** 11]:
            assert port_faunadb._ts_sort_key(ts) == \
                ref_faunadb._ts_sort_key(ts), ts
    finally:
        monkeypatch.undo()
        time.tzset()


# ---------------------------------------------------------------------------
# The driver byte for byte
# ---------------------------------------------------------------------------

def fql_exprs(q) -> list:
    cls = q.class_("test")
    ref = q.ref_(cls, 3)
    return [
        cls, q.index("all-elements"), ref, q.create_class({"name": "t"}),
        q.create_index({"name": "i", "source": cls, "active": True,
                        "terms": [{"field": ["data", "key"]}]}),
        q.create(ref, {"data": {"register": 1}}),
        q.update(ref, {"data": {"register": q.add(1, 2)}}),
        q.delete(ref), q.get_(ref), q.exists(ref),
        q.if_(q.exists(ref), q.get_(ref)), q.if_(True, 1, 2),
        q.when(q.not_(q.exists(ref)), q.create(ref, {"data": {}})),
        q.let({"a": 1, "b": q.var("a")}, {"x": q.var("b")}),
        q.select(["data", "v"], q.get_(ref)), q.equals(1, q.var("x")),
        q.subtract(5, 3), q.lt(q.var("a"), 0), q.and_(True, False),
        q.do(q.delete(ref), True), q.match(q.index("i"), 7),
        q.match(q.index("i")), q.paginate(q.match(q.index("i")), size=2),
        q.paginate(q.match(q.index("i")), after=[1, "x"]),
        q.abort("nope"), q.time("now"),
        q.lambda_(["r", "name"], q.var("name")), q.lambda_("r", 1),
        q.map_(q.lambda_("r", q.var("r")), [1, 2]),
        q.foreach(q.lambda_("r", q.delete(q.var("r"))), [ref]),
        q.at(q.time("now"), q.get_(ref)), q.at("2026-01-01T00:00:00Z", 1),
        q.Ref("7", q.Ref("test", q.Ref("classes"))), q.Ref("x"),
        {"a": [1, None, "s"], "b": {"c": q.var("x")}}, [q.var("y"), 3],
    ]


def test_fql_wire_json_equals_the_references():
    ref = [json.dumps(ref_q.wrap(e)) for e in fql_exprs(ref_q)]
    port = [json.dumps(port_q.wrap(e)) for e in fql_exprs(port_q)]
    assert port == ref
    assert len(set(port)) == len(port)


TAGGED = [
    {"@ref": {"id": "1", "class": {"@ref": {"id": "test", "class": {
        "@ref": {"id": "classes"}}}}}},
    {"@ref": "classes/test/1"}, {"@obj": {"a": {"@ts": "x"}}},
    {"@set": {"match": 1}}, {"@date": "2026-01-01"},
    {"data": [{"@ts": "1970-01-01T00:00:00.000000007Z"}, 1, None]},
    [1, [2, {"@obj": {}}]], "s", 3, None, True,
]


def test_decode_equals_the_references():
    for j in TAGGED:
        assert repr(port_q.decode(j)) == repr(ref_q.decode(j))
        assert canon(port_q.decode(j)) == canon(ref_q.decode(j))


def fauna_session(P, port: int) -> list:
    q = P["q"]
    c = q.connect("127.0.0.1", port)
    lin = q.connect("127.0.0.1", port, linearized=True)
    cls = q.class_("test")
    steps = [
        lambda: c.query(q.create_class({"name": "test"})),
        lambda: c.query(q.exists(cls)),
        lambda: c.query(q.create(q.ref_(cls, 1), {"data": {"v": 1}})),
        lambda: lin.query(q.get_(q.ref_(cls, 1))),
        lambda: c.query(q.create(q.ref_(cls, 1), {"data": {"v": 1}})),
        lambda: c.query(q.get_(q.ref_(cls, 9))),
        lambda: c.query(q.do(q.update(q.ref_(cls, 1), {"data": {"v": 2}}),
                             q.abort("nope"))),
        lambda: c.query(q.Expr({"frob": 1})),
        lambda: c.query(q.create_index({
            "name": "all", "source": cls, "active": True,
            "values": [{"field": ["data", "v"]}]})),
        lambda: c.query_all(q.match(q.index("all")), size=1),
        lambda: c.query_all_naive(q.match(q.index("all")), size=1),
        lambda: c.query(q.time("now")),
        lambda: c.query([q.time("now"), q.select(["data", "v"],
                                                 q.get_(q.ref_(cls, 1)))]),
    ]
    return [outcome(P, f) for f in steps]


def test_fauna_session_bytes_and_replies_equal_the_references(recorded):
    """The HTTP requests each package's driver sends (plain and
    /linearized, Basic auth, the API version header), and what each
    package makes of the fake's replies: equal, the duplicate create,
    the missing instance, the abort and the unknown form included."""
    got = {}
    for name, P in PKGS:
        with FakeFaunaServer() as srv:
            got[name] = canon(fauna_session(P, srv.port))
            got[name + "-port"] = srv.port
    half = len(recorded) // 2
    assert half and len(recorded) == 2 * half
    for ref_sock, port_sock in zip(recorded[:half], recorded[half:]):
        sent = [bytes(s.sent).replace(
            str(got[w + "-port"]).encode(), b"PORT")
            for w, s in (("ref", ref_sock), ("port", port_sock))]
        assert sent[1] == sent[0]
    assert got["port"] == got["ref"]
    out = got["port"]
    assert out[1] == ["ok", True]
    assert out[4][:2] == ["db-error", "instance already exists"]
    assert out[5][:2] == ["db-error", "instance not found"]
    assert out[6] == ["db-error", "transaction aborted",
                      "transaction aborted: nope", False]
    assert out[7][:2] == ["db-error", "invalid expression"]
    assert out[9] == out[10] == ["ok", [1]]
    assert b"/linearized/" in bytes(recorded[half + 3].sent)


class _ScriptedHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0) or 0)
        self.server.bodies.append(self.rfile.read(n))
        status, body = self.server.replies.pop(0)
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@contextlib.contextmanager
def scripted_http(replies: list):
    """An HTTP server answering each POST with the next (status, body)
    of `replies`; yields (port, the request bodies)."""
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _ScriptedHandler)
    srv.replies, srv.bodies = list(replies), []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address[1], srv.bodies
    finally:
        srv.shutdown()
        srv.server_close()


def errors_body(*errs) -> bytes:
    return json.dumps({"errors": [
        {"code": c, "description": d} for c, d in errs]}).encode()


#: scripted (status, body) -> what one query reads from it
FAUNA_REPLIES = {
    "ok": (200, b'{"resource": {"@ref": {"id": "1"}}}'),
    "ok-null": (200, b'{"resource": null}'),
    "no-resource": (200, b'{"data": 1}'),
    "not-json": (200, b"<html>"),
    "bad-request": (400, errors_body(("invalid expression", "no"))),
    "two-errors": (400, errors_body(("a", "x"), ("b", "y"))),
    "error-without-code": (409, json.dumps({"errors": [
        {"description": "d"}]}).encode()),
    "unauthorized-empty": (401, b""),
    "server-error": (500, errors_body(("internal error", "boom"))),
    "unavailable": (503, b"down"),
    "errors-not-a-list": (400, b'{"errors": null}'),
}


@pytest.mark.parametrize("reply", sorted(FAUNA_REPLIES))
def test_fauna_replies_and_faults_as_the_references(reply):
    """Each package's reading of the same scripted HTTP reply: the same
    value, or the same DBError (a 4xx with errors: definite) or
    DriverError (a 5xx, an empty or unparseable body: indeterminate),
    with the same `is_retriable`; the same request body."""
    got = {}
    for name, P in PKGS:
        with scripted_http([FAUNA_REPLIES[reply]]) as (port, bodies):
            c = P["q"].connect("127.0.0.1", port)
            out = outcome(P, lambda: c.query(P["q"].get_(P["q"].ref_(
                P["q"].class_("test"), 1))))
            got[name] = (repr(out).replace(str(port), "PORT"), bodies)
    assert got["port"] == got["ref"]
    if reply == "bad-request":
        assert "('db-error', 'invalid expression'" in got["port"][0]
    if reply in ("server-error", "unavailable", "not-json"):
        assert got["port"][0].startswith("('driver-error'")


def test_fauna_refused_connection_as_the_references():
    got = []
    for _name, P in PKGS:
        c = P["q"].connect("127.0.0.1", 1, timeout=2)
        got.append(outcome(P, lambda: c.query(P["q"].time("now"))))
    assert got[0] == got[1] and got[0][0] == "driver-error"


# ---------------------------------------------------------------------------
# The client op for op
# ---------------------------------------------------------------------------

def client_ops(P, mode: str) -> list:
    kv = P["ind"].tuple_
    return {
        "register": [("read", kv(1, None)), ("write", kv(1, 3)),
                     ("cas", kv(1, [3, 4])), ("cas", kv(1, [3, 5])),
                     ("cas", kv(2, [0, 1])), ("read", kv(1, None)),
                     ("frob", kv(1, None))],
        "set": [("add", 1), ("add", 5), ("add", 1), ("read", None)],
        "bank": [("read", None),
                 ("transfer", {"from": 0, "to": 3, "amount": 30}),
                 ("transfer", {"from": 3, "to": 0, "amount": 31}),
                 ("transfer", {"from": 9, "to": 0, "amount": 1}),
                 ("read", None)],
        "monotonic": [("read", None), ("inc", None), ("inc", None),
                      ("read", None)],
        "g2": [("insert", kv(1, [5, None])), ("insert", kv(1, [None, 6])),
               ("insert", kv(2, [None, 7]))],
        "pages": [("add", kv(1, [1, 2, 3])), ("add", kv(1, [4])),
                  ("add", kv(2, [9])), ("read", kv(1, None)),
                  ("read", kv(3, None))],
        "multimonotonic": [("write", {3: 0, 4: 10}), ("write", {3: 1}),
                           ("read", [3, 4, 9]), ("read", [])],
        "internal": [("create-tabby-let", 0), ("create-tabby-obj", 1),
                     ("create-tabby-arr", 2), ("change-type", None),
                     ("reset", None), ("change-type", None),
                     ("frob", None)],
    }[mode]


MODES = ("register", "set", "bank", "monotonic", "g2", "pages",
         "multimonotonic", "internal")


@pytest.mark.parametrize("mode", MODES)
def test_client_op_for_op_with_the_references(mode):
    """Every mode's ops against a fresh fake, then against a refused
    port (reads fail, mutations are indeterminate): the same
    completions in both packages."""
    got = {}
    for name, P in PKGS:
        with FakeFaunaServer() as srv:
            test = {"db-hosts": hosts_for(srv)}
            c = P["faunadb"].FaunaClient(mode).open(test, "n1")
            out = [c.invoke(test, {"type": "invoke", "f": f, "value": v,
                                   "process": 0})
                   for f, v in client_ops(P, mode)]
        gone = {"db-hosts": {"n1": ("127.0.0.1", 1)}}
        c = P["faunadb"].FaunaClient(mode, timeout=2).open(gone, "n1")
        out += [c.invoke(gone, {"type": "invoke", "f": f, "value": v,
                                "process": 0})
                for f, v in client_ops(P, mode)[:2]]
        got[name] = canon(out)
    assert got["port"] == got["ref"]
    assert [o["type"] for o in got["port"][-2:]] in (
        ["fail", "info"], ["info", "info"], ["fail", "fail"],
        ["info", "fail"])


# ---------------------------------------------------------------------------
# Checkers, grudges, the topology nemesis
# ---------------------------------------------------------------------------

def pages_history(seed: int) -> list:
    rng = random.Random(seed)
    elems = list(range(-60, 60))
    rng.shuffle(elems)
    groups = [elems[i:i + 4] for i in range(0, len(elems), 4)]
    hist, present = [], []
    for g in groups:
        hist.append({"type": "invoke", "f": "add", "value": g})
        hist.append({"type": rng.choice(["ok", "ok", "fail", "info"]),
                     "f": "add", "value": g})
        if hist[-1]["type"] != "fail":
            present.append(g)
        if rng.random() < 0.3:
            read = [e for g2 in present for e in g2]
            if rng.random() < 0.3 and read:
                read.remove(rng.choice(read))
            hist.append({"type": "invoke", "f": "read", "value": None})
            hist.append({"type": "ok", "f": "read", "value": read})
    for i, o in enumerate(hist):
        o["index"] = i
    return hist


def mm_history(seed: int) -> list:
    rng = random.Random(seed)
    vals = {k: 0 for k in "abcd"}
    hist = []
    for i in range(80):
        k = rng.choice("abcd")
        vals[k] += rng.randrange(0, 2)
        regs = {kk: {"ts": None,
                     "value": vals[kk] - (rng.random() < 0.05)}
                for kk in rng.sample(sorted(vals), rng.randrange(1, 4))}
        ts = rng.choice([f"1970-01-01T00:00:{i // 10:02d}."
                         f"{rng.randrange(10 ** 9):09d}Z",
                         1_700_000_000_000_000 + i, f"t{i}"])
        hist.append({"type": "ok", "f": "read", "index": i,
                     "value": {"ts": ts, "registers": regs}})
    return hist


def internal_history(seed: int) -> list:
    rng = random.Random(seed)
    hist = []
    for i in range(60):
        name = rng.randrange(20)
        before = rng.sample(range(20), 5)
        after = before + ([name] if rng.random() < 0.9 else [])
        if rng.random() < 0.7:
            hist.append({"type": rng.choice(["ok", "info"]), "index": i,
                         "f": rng.choice(["create-tabby-let",
                                          "create-tabby-obj",
                                          "create-tabby-arr"]),
                         "value": {"tabbies-0": before,
                                   "tabby": {"data": {"name": name}},
                                   "tabbies-1": after}})
        else:
            hist.append({"type": "ok", "f": "change-type", "index": i,
                         "value": {"cat": rng.choice(
                             [None, {"data": {"name": name}}]),
                             "tabbies": before, "calicos": after}})
    return hist


@pytest.mark.parametrize("seed", range(4))
def test_checkers_equal_the_references_on_seeded_histories(seed):
    cases = [("PagesChecker", pages_history(seed)),
             ("TsOrderChecker", mm_history(seed)),
             ("ReadSkewChecker", mm_history(seed)),
             ("InternalChecker", internal_history(seed))]
    for cls, hist in cases:
        ref = getattr(ref_faunadb, cls)().check({}, copy.deepcopy(hist), {})
        port = getattr(port_faunadb, cls)().check({}, copy.deepcopy(hist),
                                                  {})
        assert json.dumps(port, sort_keys=True, default=str) == \
            json.dumps(ref, sort_keys=True, default=str), cls


def test_read_skew_tarjan_finds_the_references_cycles():
    """A read-skew graph with several SCCs and long chains: the copied
    iterative Tarjan gives the reference's SCCs, in its order."""
    rng = random.Random(5)
    hist = []
    for i in range(150):
        regs = {k: {"ts": None, "value": rng.randrange(6)}
                for k in rng.sample("abcdef", 3)}
        hist.append({"type": "ok", "f": "read", "index": i,
                     "value": {"ts": i, "registers": regs}})
    ref = ref_faunadb.ReadSkewChecker().check({}, hist, {})
    port = port_faunadb.ReadSkewChecker().check({}, hist, {})
    assert port == ref and port["valid?"] is False


@pytest.mark.parametrize("grudge", ["intra", "inter", "single", "halves"])
def test_grudges_draw_as_the_references(grudge):
    nodes = [f"n{i}" for i in range(1, 10)]
    got = {}
    for name, P in PKGS:
        random.seed(8)
        f = {"intra": lambda: P["faunadb"].intra_replica_grudge(3),
             "inter": lambda: P["faunadb"].inter_replica_grudge(3),
             "single": lambda: P["faunadb"].single_node_grudge,
             "halves": lambda: None}[grudge]()
        if f is None:
            nem = P["faunadb"].FAUNA_NEMESES["partition"]()
            f = nem.grudge_fn
        got[name] = [{k: sorted(v) for k, v in f(nodes).items()}
                     for _ in range(10)]
    assert got["port"] == got["ref"]


def test_topology_nemesis_commands_as_the_references():
    got = {}
    for name, P in PKGS:
        test = {"nodes": ["n1", "n2", "n3", "n4", "n5"],
                "ssh": {"dummy": True}}
        remote = P["control"].remote_for(test)
        nem = P["faunadb"].TopologyNemesis().setup(test)
        outs = [nem.invoke(test, {"type": "info", "f": f}) for f in
                ("add-node", "remove-node", "remove-node", "remove-node",
                 "add-node", "add-node", "add-node", "bogus")]
        got[name] = (outs, [(n, k, str(p)) for n, k, p in remote.actions])
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# Generators, test maps, DB commands
# ---------------------------------------------------------------------------

WORKLOADS = sorted(REF["faunadb"].workloads({}))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_generators_draw_as_the_references(workload):
    got = {}
    for name, P in PKGS:
        random.seed(22)
        g = P["gen"].limit(300, P["faunadb"].workloads(
            {"concurrency": 6})[workload]()["generator"])
        got[name] = plain(simulate(P["gen"], g, perfect, concurrency=6))
    assert got["port"] == got["ref"]
    assert [o for o in got["port"] if o["type"] == "invoke"]


@pytest.mark.parametrize("nemesis", ["partition", "single-node-partition",
                                     "intra-replica-partition",
                                     "inter-replica-partition",
                                     "topology"])
def test_whole_test_generators_draw_as_the_references(nemesis):
    got = {}
    for name, P in PKGS:
        random.seed(4)
        t = P["faunadb"].faunadb_test(
            {"time-limit": 1, "nemesis-interval": 0.25,
             "nemesis": nemesis})
        got[name] = plain(simulate(P["gen"], t["generator"], perfect,
                                   concurrency=4))
    assert got["port"] == got["ref"]
    assert [o for o in got["port"] if o["process"] == "nemesis"]


MAP_OPTS = ({}, {"time-limit": 1}, {"device": "cpu"},
            {"faults": ["partition", "kill"]}, {"nemesis": "topology"},
            {"nemesis": "intra-replica-partition"}, {"version": "9.9"})


def test_test_maps_and_menus_equal_the_references():
    menu = sorted(port_faunadb.workloads({}))
    assert menu == WORKLOADS == sorted(port_faunadb.workloads())
    assert sorted(port_faunadb.FAUNA_NEMESES) == sorted(
        ref_faunadb.FAUNA_NEMESES)
    for opts in [{"workload": w, **o} for w in menu for o in MAP_OPTS]:
        ref = ref_faunadb.faunadb_test(copy.deepcopy(opts))
        port = port_faunadb.faunadb_test(copy.deepcopy(opts))
        assert map_shape(port) == map_shape(ref), opts
        assert port["db"].version == ref["db"].version
        for k in ("mode", "accounts", "total", "naive_reads", "timeout"):
            assert getattr(port["client"], k, None) == getattr(
                ref["client"], k, None), (opts, k)
    assert port_faunadb.FaunaClient.PORT == ref_faunadb.FaunaClient.PORT


@pytest.mark.parametrize("device", [None, "cpu"])
def test_register_checker_takes_the_device(device):
    t = port_faunadb.faunadb_test(
        {"workload": "register", **({"device": device} if device else {})})
    lin = t["checker"].sub
    assert type(lin).__name__ == "Linearizable" and lin.device == device
    assert type(lin.model).__name__ == "CASRegister"


def test_db_setup_commands_as_the_references():
    got = {}
    for name, P in PKGS:
        test = P["faunadb"].faunadb_test(
            {"ssh": {"dummy": True}, "nodes": ["n1", "n2", "n3"]})

        def lifecycle(t, n):
            t["os"].setup(t, n)
            t["db"].setup(t, n)
            t["db"].teardown(t, n)

        P["control"].on_nodes(test, lifecycle)
        got[name] = sorted((n, k, str(p))
                           for n, k, p in test["remote"].actions)
    assert got["port"] == got["ref"]
    assert any("faunadb-admin init" in p for _n, _k, p in got["port"])
    for P in (REF, PORT):
        db = P["faunadb"].faunadb_test({})["db"]
        assert db.log_files({}, "n1") == [REF["faunadb"].LOGFILE]


# ---------------------------------------------------------------------------
# End to end through the suite's main
# ---------------------------------------------------------------------------

def main_run(workload: str, tmp_path: Path, monkeypatch,
             device=("--device", "cpu")):
    """The suite's own main against the fake through `db-hosts`, 2 s,
    the partitioner every 0.3 s. Returns (exit code, JSON lines, the
    remote)."""
    remote = port_control.DummyRemote()
    argv = ["test", "--dummy", *device, "--store", str(tmp_path / "port"),
            "--concurrency", "4", "--workload", workload]
    with FakeFaunaServer() as srv:
        rc, lines = run_main(
            monkeypatch, port_faunadb, "faunadb_test",
            {"db-hosts": fake_hosts(srv), "time-limit": 2.0,
             "nemesis-interval": 0.3, "pages-ops-per-key": 30,
             "pages-elements": 40}, argv, remote)
    return rc, lines, remote


@pytest.mark.parametrize("workload", WORKLOADS)
def test_suite_main_equals_the_reference(workload, tmp_path, reference_env,
                                         monkeypatch):
    """`main` (`test --dummy --device cpu --workload W`) against the
    fake; the two packages' re-checks of the stored run, in turn on one
    path, give the same results (per key for registers) and files."""
    before = set(threading.enumerate())
    rc, lines, remote = main_run(workload, tmp_path, monkeypatch)
    assert no_workers_left() and no_threads_left(before)
    assert len(lines) == 1
    run = Path(lines[0]["dir"])
    res = json.loads((run / "results.json").read_text())
    hist = [json.loads(ln) for ln in
            (run / "history.jsonl").read_text().splitlines()]
    assert [o for o in hist if isinstance(o["process"], int)]
    nem = {o["f"] for o in hist if o["process"] == "nemesis"}
    assert nem <= {"start", "stop"} and "start" in nem
    assert any("iptables" in str(p) for _n, k, p in remote.actions
               if k == "execute")
    stored = json.loads((run / "test.json").read_text())
    assert stored["device"] == "cpu"
    opts = {"workload": workload, "pages-ops-per-key": 30,
            "pages-elements": 40}
    out = recheck_in_turn(
        run, tmp_path,
        lambda P: P["faunadb"].faunadb_test(dict(opts))["checker"],
        monkeypatch, pkgs=(REF, PORT))
    got = same_recheck(out)
    assert got["valid?"] == res["valid?"] == lines[0]["valid?"]
    assert rc == {True: 0, False: 1}.get(res["valid?"], 2)
    if workload == "register":
        assert per_key(got) == per_key(res) and per_key(res)
        assert all(v is True for v in per_key(res).values())
    if workload in ("register", "set", "bank", "pages", "multimonotonic",
                    "internal", "monotonic"):
        assert res["valid?"] is True


def test_register_main_without_a_card_exits_255(tmp_path, monkeypatch,
                                                capsys):
    """Without --device the register checker is the device path: no
    card here, so DeviceUnavailable and exit 255, the history stored and
    no verdict."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines, _ = main_run("register", tmp_path, monkeypatch, device=())
    assert rc == 255 and not lines
    assert "no CUDA device is available" in capsys.readouterr().err
    runs = [p.parent for p in (tmp_path / "port").rglob("history.jsonl")]
    assert len(runs) == 1 and not (runs[0] / "results.json").exists()

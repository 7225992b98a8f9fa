"""The port's BASELINE suites against the reference's: `etcd` (config
#1's suite), `yugabyte` (YSQL and YCQL, with `ycql.py` and the CI
runner `yugabyte_runner.py`) and `dgraph` (config #5's), with their
drivers `drivers/cql.py` and `drivers/dgraph_http.py`.

- The clients and drivers against the fake servers (`fake_etcd`,
  `fake_sql`, `fake_cql`, `fake_dgraph`), op for op with the
  reference's: the same completions, errors included.
- The test maps, the workload matrices, the nemesis menus and the
  `--faults` composition as the reference's.
- End to end: each suite's own `main` with the argv a user gives
  (`test --dummy --device cpu ...`), its `<db>_test` wrapped to reach
  the fakes, the history stored; the reference's checker re-checks
  the stored run with the same verdicts (per key for registers), and
  the two packages' `analyze --backend cpu`, in turn on one path, give
  the same results map (`perf`, `plot` and `indep` per key included)
  and the same files.
- The runner's command names the port's suite, and its summary exits
  with the worst outcome (`subprocess.run` stubbed).
"""

import contextlib
import copy
import io
import json
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import jepsen_tpu.cli as ref_cli
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.suites as ref_suites
import jepsen_tpu.suites.dgraph as ref_dgraph
import jepsen_tpu.suites.etcd as ref_etcd
import jepsen_tpu.suites.ycql as ref_ycql
import jepsen_tpu.suites.yugabyte as ref_yugabyte
import jepsen_tpu.suites.yugabyte_runner as ref_runner
from jepsen_tpu.drivers import DBError as RefDBError
from jepsen_tpu.drivers import cql as ref_cql
from jepsen_tpu.drivers import dgraph_http as ref_dgraph_http
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.net as port_net
import jepsen_tpu_torch.suites as port_suites
import jepsen_tpu_torch.suites.dgraph as port_dgraph
import jepsen_tpu_torch.suites.etcd as port_etcd
import jepsen_tpu_torch.suites.ycql as port_ycql
import jepsen_tpu_torch.suites.yugabyte as port_yugabyte
import jepsen_tpu_torch.suites.yugabyte_runner as port_runner
from jepsen_tpu_torch import cli
from jepsen_tpu_torch.drivers import DBError as PortDBError
from jepsen_tpu_torch.drivers import cql as port_cql
from jepsen_tpu_torch.drivers import dgraph_http as port_dgraph_http
from jepsen_tpu_torch.nemesis import NoopNemesis

from fake_cql import FakeCQLServer
from fake_dgraph import FakeDgraphServer
from fake_etcd import FakeEtcdServer
from fake_sql import FakePGServer
from test_torch_cli import reference_env  # noqa: F401
from test_torch_core_run import no_workers_left

REF = dict(ind=ref_ind, etcd=ref_etcd, yugabyte=ref_yugabyte,
           ycql=ref_ycql, dgraph=ref_dgraph, cql=ref_cql,
           dgraph_http=ref_dgraph_http, DBError=RefDBError,
           suites=ref_suites)
PORT = dict(ind=port_ind, etcd=port_etcd, yugabyte=port_yugabyte,
            ycql=port_ycql, dgraph=port_dgraph, cql=port_cql,
            dgraph_http=port_dgraph_http, DBError=PortDBError,
            suites=port_suites)
HOSTS = ("n1", "n2", "n3", "n4", "n5")


def plain(x):
    """An op or value with independent tuples as [key, value] lists, for
    comparing the two packages' completions."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        if hasattr(x, "key") and hasattr(x, "value"):
            return ["tuple", plain(x.key), plain(x.value)]
        return [plain(v) for v in x]
    return x


def fake_hosts(srv) -> dict:
    return {n: ("127.0.0.1", srv.port) for n in HOSTS}


def no_threads_left(before: set) -> bool:
    deadline = time.monotonic() + 5
    while set(threading.enumerate()) - before:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_load_suite_returns_the_ports_baseline_suites():
    import importlib
    for name, mod in (("etcd", port_etcd), ("yugabyte", port_yugabyte),
                      ("dgraph", port_dgraph)):
        assert port_suites.load_suite(name) is mod
    # every one of the 28 names loads the port's own module
    assert len(port_suites.SUITES) == 28
    for name in port_suites.SUITES:
        assert port_suites.load_suite(name) is importlib.import_module(
            f"jepsen_tpu_torch.suites.{name}")


# ---------------------------------------------------------------------------
# etcd
# ---------------------------------------------------------------------------

def etcd_ops(kv) -> list:
    """The client's cases in order: a read of a missing key, a write, a
    read, a cas that applies, one whose compare fails (412), one on a
    missing key (404), and an unknown f."""
    return [("read", kv(1, None)), ("write", kv(1, 3)),
            ("read", kv(1, None)), ("cas", kv(1, [3, 4])),
            ("read", kv(1, None)), ("cas", kv(1, [3, 0])),
            ("cas", kv(2, [0, 1])), ("read", kv(2, None)),
            ("write", kv(2, 0)), ("cas", kv(2, [0, 2])),
            ("frob", kv(2, None))]


def etcd_invoke_all(P, url: str, monkeypatch, ops, timeout=5.0,
                    quorum=False) -> list:
    monkeypatch.setattr(P["etcd"], "client_url", lambda node: url)
    c = P["etcd"].EtcdClient(timeout=timeout, quorum=quorum).open({}, "n1")
    return [plain(c.invoke({}, {"type": "invoke", "f": f, "value": v,
                                "process": 0}))
            for f, v in ops]


@pytest.mark.parametrize("quorum", [False, True])
def test_etcd_client_op_for_op_with_the_references(quorum, monkeypatch):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        with FakeEtcdServer() as srv:
            got[name] = etcd_invoke_all(P, srv.url(), monkeypatch,
                                        etcd_ops(P["ind"].tuple_),
                                        quorum=quorum)
    assert got["port"] == got["ref"]
    types = [o["type"] for o in got["port"]]
    assert types == ["fail", "ok", "ok", "ok", "ok", "fail", "fail",
                     "fail", "ok", "ok", "fail"]
    assert got["port"][0]["error"] == "not-found"
    assert got["port"][4]["value"] == ["tuple", 1, 4]
    assert got["port"][5]["error"] == got["port"][6]["error"] == \
        "precondition"


def test_etcd_client_timeouts_and_refusals_as_the_references(
        monkeypatch):
    """A stalled server (reads fail, writes are indeterminate) and a
    refused connection, op for op with the reference's client."""
    ops = lambda kv: [("read", kv(1, None)), ("write", kv(1, 2)),  # noqa
                      ("cas", kv(1, [2, 3]))]
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        with FakeEtcdServer(delay=0.5) as srv:
            slow = etcd_invoke_all(P, srv.url(), monkeypatch,
                                   ops(P["ind"].tuple_), timeout=0.1)
        refused = etcd_invoke_all(P, "http://127.0.0.1:1", monkeypatch,
                                  ops(P["ind"].tuple_))
        got[name] = (slow, refused)
    assert got["port"] == got["ref"]
    for outs in got["port"]:
        assert [o["type"] for o in outs] == ["fail", "info", "info"]
    assert "timed out" in got["port"][0][0]["error"]


def map_shape(t: dict) -> dict:
    """What a test map is made of: its names, options, the classes of
    its parts, the nemesis's fs and the checker's tree."""
    def tree(c):
        if hasattr(c, "checker_map"):
            return {k: tree(v) for k, v in sorted(c.checker_map.items())}
        if hasattr(c, "sub"):
            return {"independent": tree(c.sub)}
        return type(c).__name__

    return {"name": t.get("name"), "workload": t.get("workload"),
            "api": t.get("api"), "nemesis-name": t.get("nemesis-name"),
            "keys": sorted(k for k in t if k != "remote"),
            "db": type(t.get("db")).__name__,
            "client": type(t.get("client")).__name__,
            "client-mode": getattr(t.get("client"), "mode", None),
            "quorum": getattr(t.get("client"), "quorum", None),
            "nemesis": type(t.get("nemesis")).__name__,
            "nemesis-fs": sorted(getattr(t.get("nemesis"), "fs", ())),
            "checker": tree(t.get("checker")),
            "generator": type(t.get("generator")).__name__,
            "time-limit": t.get("time-limit"),
            "faults": t.get("faults")}


@pytest.mark.parametrize("opts", [
    {}, {"time-limit": 1}, {"quorum": True},
    {"time-limit": 1, "faults": ["partition", "kill", "pause"]},
    {"faults": ["kill"]}, {"faults": ["partition", "kill", "pause",
                                      "clock"]}],
    ids=["default", "limit", "quorum", "partition+kill+pause", "kill",
         "all-four"])
def test_etcd_test_map_equals_the_references(opts):
    ref = ref_etcd.etcd_test(copy.deepcopy(opts))
    port = port_etcd.etcd_test(copy.deepcopy(opts))
    assert map_shape(port) == map_shape(ref)
    assert map_shape(port)["checker"] == {
        "indep": {"independent": {"linear": "Linearizable",
                                  "timeline": "Timeline"}},
        "perf": {"latency-graph": "LatencyGraph",
                 "rate-graph": "RateGraph"}}


def test_etcd_faults_compose_as_the_references():
    """tests/test_suite_faults.py's composition, on the port: the
    package's nemesis replaces the suite's partitioner, and EtcdDB
    kills and pauses, so a kill-only package is no noop."""
    plain_map = port_etcd.etcd_test({"time-limit": 1})
    t = port_etcd.etcd_test({"time-limit": 1,
                             "faults": ["partition", "kill", "pause"]})
    assert type(t["nemesis"]) is not type(plain_map["nemesis"])
    kill_only = port_etcd.etcd_test({"time-limit": 1, "faults": ["kill"]})
    assert not isinstance(kill_only["nemesis"], NoopNemesis)
    assert kill_only["nemesis"].fs == {"start-kill", "stop-kill"}


@pytest.mark.parametrize("device", [None, "cpu"])
def test_etcd_linear_checker_takes_the_device(device):
    t = port_etcd.etcd_test({"device": device} if device else {})
    lin = t["checker"].checker_map["indep"].sub.checker_map["linear"]
    assert lin.device == device


def test_etcd_generator_ops_equal_the_references():
    """r, w and cas under a seeded `random`: values 0-4."""
    import random
    for fn in ("r", "w", "cas"):
        random.seed(11)
        ref = [getattr(ref_etcd, fn)() for _ in range(50)]
        random.seed(11)
        port = [getattr(port_etcd, fn)() for _ in range(50)]
        assert port == ref
    assert {port_etcd.w()["value"] for _ in range(100)} <= set(range(5))


def test_etcd_db_commands_as_the_references(monkeypatch):
    """EtcdDB's setup and teardown on the dummy remote: the same
    commands node by node (setup's 5 s wait for the daemon skipped)."""
    monkeypatch.setattr(time, "sleep", lambda s: None)
    out = {}
    for name, P, ctl in (("ref", REF, None), ("port", PORT, port_control)):
        import jepsen_tpu.control as ref_control
        c = ctl or ref_control
        test = {"nodes": ["n1", "n2", "n3"], "ssh": {"dummy": True}}
        remote = c.remote_for(test)
        db = P["etcd"].EtcdDB()
        c.on_nodes(test, db.setup)
        c.on_nodes(test, db.teardown)
        out[name] = sorted((n, k, str(p)) for n, k, p in remote.actions)
    assert out["port"] == out["ref"]
    assert any("--initial-cluster" in p for _n, _k, p in out["port"])


# ---------------------------------------------------------------------------
# Suite runs through each suite's main
# ---------------------------------------------------------------------------

def on_the_fakes(t: dict, remote) -> dict:
    """A suite's test map made ready for the fake servers, keeping the
    nemesis: no daemons (db and os go; a fault package still holds the
    suite's DB), the iptables net so partitions reach the remote, and
    the caller's dummy remote."""
    t.pop("db", None)
    t.pop("os", None)
    t["net"] = port_net.iptables()
    t["remote"] = remote
    return t


def run_main(monkeypatch, mod, make_name: str, extra: dict, argv: list,
             remote) -> tuple:
    """`mod.main(argv)`, the suite's own entry point, with its
    `<db>_test` wrapped to add `extra` (the fakes' hosts, the time limit,
    the nemesis interval) and to make the map ready for the fakes;
    returns (exit code, its JSON lines)."""
    real = getattr(mod, make_name)

    def make(opts=None):
        return on_the_fakes(real({**(opts or {}), **extra}), remote)

    monkeypatch.setattr(mod, make_name, make)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    monkeypatch.setattr(mod, make_name, real)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]


def analyze_cpu(clis, run: Path, store: Path, check) -> tuple:
    """`analyze --backend cpu` of `run` under `store` with `check`;
    returns (exit code, results)."""
    with contextlib.redirect_stdout(io.StringIO()):
        rc = clis.run_cli(lambda t, a: {**t, "checker": check},
                          argv=["analyze", str(run), "--store",
                                str(store), "--backend", "cpu"])
    return rc, json.loads((run / "results.json").read_text())


#: The files the checkers write into a run dir: the results and the
#: artifacts (plots, timelines, linearizability diagrams).
ARTIFACTS = (".json", ".edn", ".png", ".html", ".svg")


def checker_files(run: Path) -> dict:
    skip = {"test.json", "history.jsonl", "trace.json", "metrics.json",
            "events.jsonl"}
    return {str(p.relative_to(run)): p.read_bytes()
            for p in sorted(run.rglob("*"))
            if p.is_file() and p.suffix in ARTIFACTS and p.name not in skip
            and not p.name.startswith("history")}


def recheck_in_turn(run: Path, tmp_path: Path, make_check,
                    monkeypatch, pkgs: tuple = (REF, PORT)) -> dict:
    """Both packages' `analyze --backend cpu` of a copy of the stored
    run, in turn on one path, each with its package's checker
    (`make_check(P)`, P each of `pkgs`: the reference's, the port's);
    returns {pkg: (exit code, results, {file: bytes})}."""
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "cpu")
    store = tmp_path / "recheck"
    path = store / run.parent.name / run.name
    out = {}
    for name, clis, P in (("ref", ref_cli, pkgs[0]),
                          ("port", cli, pkgs[1])):
        shutil.rmtree(store, ignore_errors=True)
        shutil.copytree(run, path)
        rc, res = analyze_cpu(clis, path, store, make_check(P))
        out[name] = (rc, res, checker_files(path))
    shutil.rmtree(store, ignore_errors=True)
    return out


def same_recheck(out: dict) -> dict:
    (rrc, rres, rfiles), (prc, pres, pfiles) = out["ref"], out["port"]
    assert prc == rrc
    assert json.dumps(pres, sort_keys=True, default=str) == \
        json.dumps(rres, sort_keys=True, default=str)
    assert sorted(pfiles) == sorted(rfiles)
    for f in rfiles:
        assert pfiles[f] == rfiles[f], f
    return pres


def per_key(res: dict) -> dict:
    return {k: r["valid?"] for k, r in (res.get("results") or {}).items()}


def test_etcd_main_under_faults_equals_the_reference(
        tmp_path, reference_env, monkeypatch):
    """etcd's `main` (`test --dummy --faults partition,kill,pause,clock
    --device cpu`) against the fake etcd at the published shape, cut to
    a 2 s limit: every family's ops in the history, each key's verdict
    the reference checker's, and the two packages' re-checks of the
    stored run equal in every key (`perf`, `indep` per key) and file."""
    remote = port_control.DummyRemote()
    before = set(threading.enumerate())
    with FakeEtcdServer() as srv:
        monkeypatch.setattr(port_etcd, "client_url", lambda n: srv.url())
        rc, lines = run_main(
            monkeypatch, port_etcd, "etcd_test",
            {"time-limit": 2.0, "nemesis-interval": 0.3}, [
                "test", "--dummy", "--faults", "partition,kill,pause,clock",
                "--device", "cpu", "--store", str(tmp_path / "port"),
                "--concurrency", "10"], remote)
    assert no_workers_left() and no_threads_left(before)
    assert rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True
    run = Path(lines[0]["dir"])
    res = json.loads((run / "results.json").read_text())
    assert sorted(res) == ["indep", "perf", "valid?"]
    assert res["perf"]["valid?"] is True
    keys = per_key(res["indep"])
    assert keys and all(v is True for v in keys.values())
    assert (run / "latency-raw.png").is_file()
    hist = [json.loads(ln) for ln in
            (run / "history.jsonl").read_text().splitlines()]
    fs = {o["f"] for o in hist if o["process"] == "nemesis"
          and o["type"] == "info"}
    assert {"start-partition", "start-kill", "start-pause"} <= fs
    assert fs & {"bump", "strobe"}
    client_fs = {o["f"] for o in hist if isinstance(o["process"], int)}
    assert client_fs <= {"read", "write", "cas"}
    stored = json.loads((run / "test.json").read_text())
    assert stored["device"] == "cpu" and stored["concurrency"] == 10
    # the reference's checker on the stored run: the same per-key verdicts
    out = recheck_in_turn(run, tmp_path,
                          lambda P: P["etcd"].etcd_test({})["checker"],
                          monkeypatch)
    got = same_recheck(out)
    assert per_key(got["indep"]) == keys
    assert got["valid?"] is True and out["port"][0] == rc


# ---------------------------------------------------------------------------
# yugabyte
# ---------------------------------------------------------------------------

def test_yugabyte_matrix_and_menus_equal_the_references():
    for api in ref_yugabyte.APIS:
        assert sorted(port_yugabyte.workloads(api=api)) == \
            sorted(ref_yugabyte.workloads(api=api)), api
    assert port_yugabyte.APIS == ref_yugabyte.APIS
    assert sorted(port_yugabyte.NEMESES) == sorted(ref_yugabyte.NEMESES)
    for name, ctor in port_yugabyte.NEMESES.items():
        assert type(ctor()).__name__ == \
            type(ref_yugabyte.NEMESES[name]()).__name__, name
    ref_all = [map_shape(t) for t in ref_yugabyte.all_tests({})]
    port_all = [map_shape(t) for t in port_yugabyte.all_tests({})]
    assert len(port_all) == len(ref_all) == 12
    assert port_all == ref_all
    assert sorted(port_ycql.MODES) == sorted(ref_ycql.MODES)


@pytest.mark.parametrize("api", ["ysql", "ycql"])
@pytest.mark.parametrize("nemesis", ["partition", "pause-tserver",
                                     "none"])
def test_yugabyte_test_maps_equal_the_references(api, nemesis):
    for w in sorted(port_yugabyte.workloads(api=api)):
        opts = {"api": api, "workload": w, "nemesis": nemesis,
                "faults": ["kill"] if w == "bank" else None}
        assert map_shape(port_yugabyte.yugabyte_test(dict(opts))) == \
            map_shape(ref_yugabyte.yugabyte_test(dict(opts))), (api, w)
    with pytest.raises(ValueError, match="unknown nemesis"):
        port_yugabyte.yugabyte_test({"nemesis": "nope"})


def test_ycql_bank_allows_negative_balances_as_the_reference():
    for P in (REF, PORT):
        chk = P["yugabyte"].workloads(api="ycql")["bank"]()["checker"]
        assert chk.checker_map["bank"].negative_balances is True
        chk = P["yugabyte"].workloads(api="ysql")["bank"]()["checker"]
        assert chk.checker_map["bank"].negative_balances is False


def cql_session(P, port: int) -> list:
    """A CQL session's results: DDL, upserts, lightweight transactions
    applied and not, a transaction block, list appends, an error."""
    conn = P["cql"].connect("127.0.0.1", port)
    out = []
    for q in ("CREATE KEYSPACE IF NOT EXISTS jepsen", "USE jepsen",
              "CREATE TABLE IF NOT EXISTS registers (id bigint PRIMARY "
              "KEY, val bigint) WITH transactions = {'enabled': true}",
              "INSERT INTO registers (id, val) VALUES (1, 5)",
              "SELECT val FROM registers WHERE id = 1",
              "UPDATE registers SET val = 6 WHERE id = 1 IF val = 5",
              "UPDATE registers SET val = 9 WHERE id = 1 IF val = 5",
              "INSERT INTO registers (id, val) VALUES (2, 1) IF NOT EXISTS",
              "INSERT INTO registers (id, val) VALUES (2, 3) IF NOT EXISTS",
              "BEGIN TRANSACTION UPDATE registers SET val = val - 1 "
              "WHERE id = 1; UPDATE registers SET val = val + 1 WHERE "
              "id = 2; END TRANSACTION;",
              "SELECT id, val FROM registers WHERE id IN (1, 2, 3)",
              "CREATE TABLE IF NOT EXISTS lists (id bigint PRIMARY KEY, "
              "val list<bigint>)",
              "UPDATE lists SET val = val + [7] WHERE id = 4",
              "UPDATE lists SET val = val + [8] WHERE id = 4",
              "SELECT val FROM lists WHERE id = 4",
              "SELECT val FROM nosuchtable WHERE id = 1"):
        try:
            r = conn.query(q)
            out.append(("ok", r.columns, r.rows, r.kind))
        except P["DBError"] as e:
            out.append(("error", str(e.code), e.message))
    conn.close()
    return out


def test_cql_driver_round_trips_as_the_references():
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        with FakeCQLServer() as srv:
            got[name] = cql_session(P, srv.port)
    assert got["port"] == got["ref"]
    assert got["port"][4][2] == [[5]]
    assert got["port"][5][2] == [[True]] and got["port"][6][2][0][0] is \
        False
    assert got["port"][14][2] == [[[7, 8]]]
    assert got["port"][-1][0] == "error"


def test_cql_auth_as_the_references():
    for P in (REF, PORT):
        with FakeCQLServer(password="cassandra") as srv:
            conn = P["cql"].connect("127.0.0.1", srv.port, user="cassandra",
                                    password="cassandra")
            conn.query("CREATE KEYSPACE IF NOT EXISTS jepsen")
            conn.close()
            with pytest.raises(P["DBError"]):
                P["cql"].connect("127.0.0.1", srv.port, user="x",
                                 password="bad")


def ycql_ops(kv) -> dict:
    return {
        "register": [("write", kv(3, 7)), ("read", kv(3, None)),
                     ("cas", kv(3, [7, 8])), ("cas", kv(3, [7, 9])),
                     ("read", kv(3, None)), ("read", kv(4, None)),
                     ("frob", kv(4, None))],
        "bank": [("read", None),
                 ("transfer", {"from": 0, "to": 2, "amount": 10}),
                 ("transfer", {"from": 1, "to": 3, "amount": 4}),
                 ("read", None)],
        "set": [("add", 5), ("add", 2), ("add", 5), ("read", None)],
        "monotonic": [("inc", None), ("inc", None), ("read", None)],
        "long-fork": [("write", [["w", 21, 1]]),
                      ("read", [["r", 21, None], ["r", 22, None]]),
                      ("write", [["w", 22, 1], ["r", 21, None]])],
    }


def test_ycql_client_modes_op_for_op_with_the_references():
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        out = {}
        for mode, ops in ycql_ops(P["ind"].tuple_).items():
            with FakeCQLServer() as srv:
                test = {"db-hosts": fake_hosts(srv)}
                c = P["ycql"].client_for(mode, {}).open(test, "n1")
                out[mode] = [plain(c.invoke(test, {
                    "type": "invoke", "f": f, "value": v,
                    "process": 0})) for f, v in ops]
                c.close(test)
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"]["register"][4]["value"] == ["tuple", 3, 8]
    assert sum(got["port"]["bank"][-1]["value"].values()) == 100
    assert got["port"]["set"][-1]["value"] == [2, 5]
    with pytest.raises(ValueError, match="no YCQL client"):
        port_ycql.client_for("append")


def test_ycql_client_without_a_server_as_the_reference():
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        test = {"db-hosts": {"n1": ("127.0.0.1", 1)}}
        c = P["ycql"].client_for("register", {}).open(test, "n1")
        got[name] = [plain(c.invoke(test, {"type": "invoke", "f": f,
                                           "value": P["ind"].tuple_(1, v),
                                           "process": 0}))
                     for f, v in (("read", None), ("write", 2))]
    assert got["port"] == got["ref"]
    assert [o["type"] for o in got["port"]] == ["fail", "info"]


YUGA_RUNS = {
    # (api, workload): the fake, the kernel the verdict reaches
    ("ysql", "append"): FakePGServer,
    ("ycql", "register"): FakeCQLServer,
    ("ycql", "bank"): FakeCQLServer,
}


@pytest.mark.parametrize("api,workload", sorted(YUGA_RUNS),
                         ids=lambda x: x)
def test_yugabyte_main_equals_the_reference(api, workload, tmp_path,
                                            reference_env, monkeypatch):
    """yugabyte's `main` (`test --dummy --api A --workload W --nemesis
    partition --device cpu`) against the fake server of its API; the
    reference's checker on the stored run, and both packages' re-checks
    in turn, give the same results and files."""
    remote = port_control.DummyRemote()
    before = set(threading.enumerate())
    with YUGA_RUNS[api, workload]() as srv:
        rc, lines = run_main(
            monkeypatch, port_yugabyte, "yugabyte_test",
            {"db-hosts": fake_hosts(srv), "time-limit": 2.5,
             "nemesis-interval": 0.3},
            ["test", "--dummy", "--api", api, "--workload", workload,
             "--nemesis", "partition", "--device", "cpu", "--store",
             str(tmp_path / "port"), "--concurrency", "5"], remote)
    assert no_workers_left() and no_threads_left(before)
    assert rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True
    run = Path(lines[0]["dir"])
    assert run.parent.name == f"yugabyte-{api} {workload}"
    hist = [json.loads(ln) for ln in
            (run / "history.jsonl").read_text().splitlines()]
    fs = {o["f"] for o in hist if o["process"] == "nemesis"
          and o["type"] == "info"}
    assert fs == {"start", "stop"}
    assert any("iptables" in str(p) for _n, k, p in remote.actions
               if k == "execute")
    out = recheck_in_turn(
        run, tmp_path,
        lambda P: P["yugabyte"].workloads({}, api)[workload]()["checker"],
        monkeypatch)
    got = same_recheck(out)
    res = json.loads((run / "results.json").read_text())
    assert got["valid?"] == res["valid?"] is True
    if workload == "register":
        assert per_key(got) == per_key(res) and per_key(res)
    if workload == "bank":
        assert sorted(res) == ["bank", "plot", "valid?"]
        assert "bank.png" in out["port"][2]


class StubRun:
    """`subprocess.run` for the runner: records each command and answers
    from `outcomes` by workload (an int is the exit code, "timeout"
    raises TimeoutExpired)."""

    def __init__(self, outcomes: dict):
        self.outcomes = outcomes
        self.cmds: list = []

    def __call__(self, cmd, timeout=None, **kw):
        self.cmds.append(list(cmd))
        w = cmd[cmd.index("--workload") + 1]
        got = self.outcomes.get(w, 0)
        if got == "timeout":
            raise subprocess.TimeoutExpired(cmd, timeout)
        return subprocess.CompletedProcess(cmd, got)


@pytest.mark.parametrize("outcomes,worst", [
    ({}, 0),
    ({"set": 1}, 1),
    ({"set": 1, "bank": 255}, 2),
    ({"bank": "timeout"}, 2),
    ({"set": 1, "bank": "timeout", "register": 254}, 2)],
    ids=["valid", "invalid", "error", "timeout", "all"])
def test_yugabyte_runner_exits_with_the_worst_outcome(outcomes, worst,
                                                      monkeypatch):
    argv = ["--workloads", "bank,set,register", "--nemeses",
            "none,partition", "--apis", "ysql,ycql", "--time-limit", "5",
            "--nodes", "a,b,c", "--test-timeout", "9", "--extra",
            "--device cpu"]
    got = {}
    for name, mod in (("ref", ref_runner), ("port", port_runner)):
        stub = StubRun(outcomes)
        monkeypatch.setattr(mod.subprocess, "run", stub)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        got[name] = (rc, buf.getvalue(), stub.cmds)
    (rrc, rout, rcmds), (prc, pout, pcmds) = got["ref"], got["port"]
    assert prc == rrc == worst
    assert pout.replace("jepsen_tpu_torch", "jepsen_tpu") == rout
    assert len(pcmds) == len(rcmds) == 12
    for p, r in zip(pcmds, rcmds):
        assert p[1:3] == ["-m", "jepsen_tpu_torch.suites.yugabyte"]
        assert r[1:3] == ["-m", "jepsen_tpu.suites.yugabyte"]
        assert p[3:] == r[3:]
    assert pcmds[0][3:] == ["test", "--workload", "bank", "--api", "ysql",
                            "--time-limit", "5", "--nemesis", "none",
                            "-n", "a", "-n", "b", "-n", "c", "--device",
                            "cpu"]
    want = {0: "valid", 1: "invalid", "timeout": "timeout"}
    for ln in pout.splitlines():
        if ln.startswith("  ") and "s" in ln:
            w = ln.split()[1]
            o = outcomes.get(w, 0)
            assert ln.split()[3] == want.get(o, "error"), ln


def test_yugabyte_runner_default_matrix_as_the_references(monkeypatch):
    """No --workloads: each API's own matrix, in the reference's order."""
    got = {}
    for name, mod in (("ref", ref_runner), ("port", port_runner)):
        stub = StubRun({})
        monkeypatch.setattr(mod.subprocess, "run", stub)
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod.main(["--nemeses", "none"]) == 0
        got[name] = [c[3:] for c in stub.cmds]
    assert got["port"] == got["ref"]
    assert len(got["port"]) == 12


# ---------------------------------------------------------------------------
# dgraph
# ---------------------------------------------------------------------------

def dgraph_session(P, port: int) -> list:
    conn = P["dgraph_http"].connect("127.0.0.1", port)
    out = [conn.alter(P["dgraph"].SCHEMA)]
    out.append(conn.mutate(set_obj=[{"key": 1, "val": 5}]))
    out.append(conn.query("{ q(func: eq(key, 1)) { val } }"))
    t1, t2 = conn.begin(), conn.begin()
    u1 = t1.query("{ q(func: eq(key, 1)) { uid } }")["data"]["q"][0]
    u2 = t2.query("{ q(func: eq(key, 1)) { uid } }")["data"]["q"][0]
    t1.mutate(set_obj=[{"uid": u1["uid"], "val": 6}])
    t2.mutate(set_obj=[{"uid": u2["uid"], "val": 7}])
    out.append(t1.commit())
    try:
        t2.commit()
        out.append("committed")
    except P["DBError"] as e:
        out.append(("aborted", e.code))
    out.append(conn.query("{ q(func: eq(key, 1)) { val } }"))
    return [plain(x) for x in out]


def test_dgraph_driver_round_trips_as_the_references():
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        with FakeDgraphServer() as srv:
            got[name] = dgraph_session(P, srv.port)
    assert got["port"] == got["ref"]
    assert got["port"][4] == ["aborted", "409"]
    assert got["port"][-1]["data"]["q"] == [{"val": 6}]


def dgraph_ops(kv) -> dict:
    return {
        "register": [("read", kv(1, None)), ("write", kv(1, 3)),
                     ("read", kv(1, None)), ("cas", kv(1, [3, 4])),
                     ("cas", kv(1, [3, 0])), ("write", kv(1, 2)),
                     ("read", kv(1, None)), ("frob", kv(1, None))],
        "bank": [("read", None),
                 ("transfer", {"from": 0, "to": 2, "amount": 10}),
                 ("transfer", {"from": 3, "to": 1, "amount": 4}),
                 ("read", None)],
        "set": [("add", 4), ("add", 1), ("read", None)],
        "sequential": [("write", kv(2, 1)), ("write", kv(2, 5)),
                       ("read", kv(2, None))],
        "upsert": [("insert", kv(3, [1, None])),
                   ("insert", kv(3, [None, 2])),
                   ("insert", kv(4, [None, 2]))],
        "long-fork": [("txn", [["w", 9, 1]]),
                      ("txn", [["r", 9, None], ["r", 8, None]]),
                      ("txn", [["w", 8, 2], ["r", 9, None]])],
        "delete": [("delete", kv(4, None)), ("upsert", kv(4, None)),
                   ("upsert", kv(4, None)), ("read", kv(4, None)),
                   ("delete", kv(4, None)), ("read", kv(4, None))],
    }


def test_dgraph_client_modes_op_for_op_with_the_references():
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        out = {}
        for w, ops in dgraph_ops(P["ind"].tuple_).items():
            with FakeDgraphServer() as srv:
                test = {"db-hosts": fake_hosts(srv)}
                c = P["dgraph"].default_client(w, {}).open(test, "n1")
                out[w] = [plain(c.invoke(test, {
                    "type": "invoke", "f": f, "value": v,
                    "process": 0})) for f, v in ops]
                c.close(test)
        got[name] = out
    assert got["port"] == got["ref"]
    assert sorted(got["port"]) == sorted(port_dgraph.MODES)
    assert got["port"]["register"][6]["value"] == ["tuple", 1, 2]
    assert got["port"]["bank"][1]["type"] == "ok"
    assert got["port"]["upsert"][1]["type"] == "fail"
    assert [o["type"] for o in got["port"]["delete"]] == \
        ["fail", "ok", "fail", "ok", "ok", "ok"]


def test_dgraph_client_without_a_server_as_the_reference():
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        test = {"db-hosts": {"n1": ("127.0.0.1", 1)}}
        c = P["dgraph"].default_client("register", {}).open(test, "n1")
        got[name] = [plain(c.invoke(test, {"type": "invoke", "f": f,
                                           "value": P["ind"].tuple_(1, v),
                                           "process": 0}))
                     for f, v in (("read", None), ("write", 2))]
    assert got["port"] == got["ref"]
    assert [o["type"] for o in got["port"]] == ["fail", "info"]


def delete_reads(seed: int, n: int = 60) -> list:
    """Ok reads of every shape DeleteChecker judges (none, one good
    record, two, a half-deleted one, a wrong key, a non-list), drawn
    from a numpy seed, with other ops between them."""
    rng = np.random.default_rng(seed)
    shapes = [[], [{"uid": "0x1", "key": 3}],
              [{"uid": "0x1", "key": 3}, {"uid": "0x2", "key": 3}],
              [{"uid": "0x1"}], [{"uid": "0x1", "key": 9}],
              [{"uid": "", "key": 3}], None, "junk"]
    out = []
    for i in range(n):
        k = int(rng.integers(0, len(shapes)))
        typ = ["ok", "ok", "ok", "fail", "info"][int(rng.integers(0, 5))]
        f = ["read", "read", "upsert", "delete"][int(rng.integers(0, 4))]
        out.append({"type": typ, "f": f, "process": i % 4,
                    "value": copy.deepcopy(shapes[k])})
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("key", [3, None])
def test_delete_checker_verdicts_equal_the_references(seed, key):
    hist = delete_reads(seed)
    opts = {} if key is None else {"history-key": key}
    ref = ref_dgraph.DeleteChecker().check({}, copy.deepcopy(hist), opts)
    port = port_dgraph.DeleteChecker().check({}, copy.deepcopy(hist), opts)
    assert port == ref


def test_dgraph_workloads_and_maps_equal_the_references():
    assert sorted(port_dgraph.workloads({})) == \
        sorted(ref_dgraph.workloads({}))
    assert port_dgraph.MODES == ref_dgraph.MODES
    for w in sorted(port_dgraph.workloads({})):
        for faults in (None, ["partition", "pause"]):
            opts = {"workload": w, "faults": faults}
            assert map_shape(port_dgraph.dgraph_test(dict(opts))) == \
                map_shape(ref_dgraph.dgraph_test(dict(opts))), w


#: The set workload reads once, after its 100 adds: a limit that ends
#: the run before the adds do (a loaded host) leaves the set unread, and
#: the verdict unknown ("Set was never read").
DGRAPH_LIMITS = {"set": 6.0}


@pytest.mark.parametrize("workload", ["set", "register", "delete", "bank"])
def test_dgraph_main_equals_the_reference(workload, tmp_path,
                                          reference_env, monkeypatch):
    """dgraph's `main` (`test --dummy --workload W --device cpu`) against
    the fake dgraph; the two packages' re-checks of the stored run in
    turn give the same results and files (per key for register and
    delete)."""
    remote = port_control.DummyRemote()
    before = set(threading.enumerate())
    with FakeDgraphServer() as srv:
        rc, lines = run_main(
            monkeypatch, port_dgraph, "dgraph_test",
            {"db-hosts": fake_hosts(srv),
             "time-limit": DGRAPH_LIMITS.get(workload, 2.5),
             "nemesis-interval": 0.3},
            ["test", "--dummy", "--workload", workload, "--device", "cpu",
             "--store", str(tmp_path / "port"), "--concurrency", "10"],
            remote)
    assert no_workers_left() and no_threads_left(before)
    assert rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True
    run = Path(lines[0]["dir"])
    out = recheck_in_turn(
        run, tmp_path,
        lambda P: P["dgraph"].workloads({})[workload]()["checker"],
        monkeypatch)
    got = same_recheck(out)
    res = json.loads((run / "results.json").read_text())
    assert got["valid?"] == res["valid?"] is True
    if workload in ("register", "delete"):
        assert per_key(got) == per_key(res) and per_key(res)

"""The port's suite layer against the reference's: `suites/__init__.py`
(the registry, `standard_workloads`, `suite_test`, `all_tests`), the
`cockroach` and `tidb` suites with their mains, the workloads they add
(`set_workload`, `monotonic`, `causal_reverse`, `adya`, `comments`), and
the CLI's `--device` and `--faults` reaching them.

- The registry and the test maps: the reference's names, each loading
  the port's own module, workloads, nemesis menus and option sweeps.
- The workloads' generators op for op under a seeded `random`, and
  their checkers on the same histories.
- Suite runs through `run_cli` as a suite's main calls it, against the
  fake SQL servers, under `--faults`: the fault families reach the
  history and the dummy remote; `test-all` over cockroach's workloads;
  each stored run re-checked by the reference's checker gives the same
  verdict.
- Without a card, a suite's default test map stores the history and
  exits 255.
"""

import argparse
import contextlib
import io
import json
import random
import shutil
import threading
import time
from pathlib import Path

import pytest
import torch

import jepsen_tpu.cli as ref_cli
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.suites as ref_suites
import jepsen_tpu.suites.cockroach as ref_cockroach
import jepsen_tpu.suites.tidb as ref_tidb
import jepsen_tpu.workloads.adya as ref_adya
import jepsen_tpu.workloads.causal_reverse as ref_causal_reverse
import jepsen_tpu.workloads.comments as ref_comments
import jepsen_tpu.workloads.monotonic as ref_monotonic
import jepsen_tpu.workloads.set_workload as ref_set
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.core as port_core
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.net as port_net
import jepsen_tpu_torch.suites as port_suites
import jepsen_tpu_torch.suites.cockroach as port_cockroach
import jepsen_tpu_torch.suites.tidb as port_tidb
import jepsen_tpu_torch.workloads.adya as port_adya
import jepsen_tpu_torch.workloads.causal_reverse as port_causal_reverse
import jepsen_tpu_torch.workloads.comments as port_comments
import jepsen_tpu_torch.workloads.monotonic as port_monotonic
import jepsen_tpu_torch.workloads.set_workload as port_set
from jepsen_tpu_torch import cli, workloads
from jepsen_tpu_torch.nemesis import NoopNemesis
from jepsen_tpu_torch.store import Store

from fake_sql import FakeMySQLServer, FakePGServer
from test_torch_cli import reference_env  # noqa: F401
from test_torch_core_run import no_workers_left
from test_torch_generator import make_imperfect, perfect, simulate

REF = dict(suites=ref_suites, cockroach=ref_cockroach, tidb=ref_tidb,
           gen=ref_gen, ind=ref_ind, set=ref_set, monotonic=ref_monotonic,
           causal_reverse=ref_causal_reverse, adya=ref_adya,
           comments=ref_comments)
PORT = dict(suites=port_suites, cockroach=port_cockroach, tidb=port_tidb,
            gen=port_gen, ind=port_ind, set=port_set,
            monotonic=port_monotonic, causal_reverse=port_causal_reverse,
            adya=port_adya, comments=port_comments)
NODES = ["n1", "n2", "n3"]
FAMILY_FS = {"partition": {"start-partition", "stop-partition"},
             "kill": {"start-kill", "stop-kill"},
             "pause": {"start-pause", "stop-pause"},
             "clock": {"bump", "strobe", "reset"}}


def no_threads_left(before: set) -> bool:
    """No thread started since `before` is alive within 5 s: the
    clients' sockets are closed, so the fake servers' handler threads
    end."""
    deadline = time.monotonic() + 5
    while set(threading.enumerate()) - before:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


# ---------------------------------------------------------------------------
# The registry and the test maps
# ---------------------------------------------------------------------------

def test_suite_registry_loads_the_ported_suites():
    """The reference's 28 names; each loads the port's own module, with
    its main and workloads, and an unknown name is a ValueError, as the
    reference's `load_suite`."""
    assert port_suites.SUITES == ref_suites.SUITES
    assert len(port_suites.SUITES) == 28
    for name in port_suites.SUITES:
        mod = port_suites.load_suite(name)
        assert mod.__name__ == f"jepsen_tpu_torch.suites.{name}", name
        assert callable(mod.main), name
        assert callable(mod.workloads), name
    assert not hasattr(port_suites, "PORTED")
    assert not hasattr(port_suites, "SuiteNotPorted")
    with pytest.raises(ValueError, match="unknown suite"):
        port_suites.load_suite("nope")


def test_standard_workloads_resolve_as_the_references():
    ref = ref_suites.standard_workloads(ref_suites.base_opts())
    port = port_suites.standard_workloads(port_suites.base_opts())
    assert sorted(port) == sorted(ref)
    for name, fn in port.items():
        pkg = fn()
        assert pkg.get("generator") is not None, name
        assert pkg.get("checker") is not None, name
        assert sorted(pkg) == sorted(ref[name]()), name


def checker_device(chk):
    """The `device` a workload's device-path checker was built with."""
    while not hasattr(chk, "device"):
        chk = chk.sub          # independent.checker's per-key checker
    return chk.device


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_standard_workloads_pass_the_device(device):
    opts = port_suites.base_opts(**({"device": device} if device else {}))
    std = port_suites.standard_workloads(opts)
    for name in ("append", "wr", "register"):
        assert checker_device(std[name]()["checker"]) == device, name


def map_shape(P, t: dict) -> dict:
    """What a suite's test map is made of: its names and options, the
    classes of its parts and the nemesis's fs."""
    return {"name": t["name"], "workload": t["workload"],
            "keys": sorted(k for k in t if k != "remote"),
            "nodes": t["nodes"], "concurrency": t["concurrency"],
            "time-limit": t.get("time-limit"),
            "db": type(t.get("db")).__name__,
            "client": type(t.get("client")).__name__,
            "client-mode": getattr(t.get("client"), "mode", None),
            "nemesis": type(t.get("nemesis")).__name__,
            "nemesis-fs": sorted(getattr(t.get("nemesis"), "fs", ())),
            "checker": checker_name(t),
            "generator": type(t.get("generator")).__name__}


def checker_name(t: dict) -> str:
    """The test map's checker class. The bank checker composes the
    balance invariant with its plot (`{"bank", "plot"}`) in both
    packages: there, the invariant's class."""
    chk = t.get("checker")
    if t["workload"] == "bank" and type(chk).__name__ == "Compose":
        assert sorted(chk.checker_map) == ["bank", "plot"]
        chk = chk.checker_map["bank"]
    return type(chk).__name__


@pytest.mark.parametrize("suite", ["cockroach", "tidb"])
@pytest.mark.parametrize("faults", [None, ["partition"],
                                    ["partition", "kill", "pause", "clock"]],
                         ids=lambda f: "+".join(f) if f else "default")
def test_suite_test_maps_equal_the_references(suite, faults):
    for w in sorted(PORT[suite].workloads()):
        opts = {"workload": w, "time-limit": 2,
                **({"faults": faults} if faults else {})}
        got = {}
        for name, P in (("ref", REF), ("port", PORT)):
            make = getattr(P[suite], f"{suite}_test")
            got[name] = map_shape(P, make(dict(opts)))
        assert got["port"] == got["ref"], w


def test_cockroach_nemesis_menu():
    assert sorted(port_cockroach.NEMESES) == sorted(ref_cockroach.NEMESES)
    for name, ctor in port_cockroach.NEMESES.items():
        assert type(ctor()).__name__ == \
            type(ref_cockroach.NEMESES[name]()).__name__, name
    t = port_cockroach.cockroach_test({"ssh": {"dummy": True},
                                       "nemesis": "clock"})
    assert t["nemesis-name"] == "clock"
    with pytest.raises(ValueError, match="unknown nemesis"):
        port_cockroach.cockroach_test({"ssh": {"dummy": True},
                                       "nemesis": "bogus"})


def test_unknown_workload_raises():
    with pytest.raises(ValueError, match="unknown workload"):
        port_suites.suite_test("x", "nope", port_suites.base_opts(),
                               port_suites.standard_workloads())


def test_resolve_workload_and_stored_identity():
    rw = port_suites.resolve_workload
    assert rw(argparse.Namespace(workload=None), {"workload": "bank"},
              "append") == "bank"
    assert rw(argparse.Namespace(workload=None), {}, "append") == "append"
    assert rw(argparse.Namespace(workload="set"), {"workload": "bank"},
              "append") == "set"
    opts = port_suites.base_opts(**{"start-time": "20200101T000000",
                                    "name": "tidb bank",
                                    "workload": "bank"})
    t = port_suites.suite_test("tidb", "bank", opts,
                               port_suites.standard_workloads())
    assert t["start-time"] == "20200101T000000"
    assert t["name"] == "tidb bank"


def test_all_tests_equal_the_references():
    opts = {"time-limit": 1}
    for P in (REF, PORT):
        P["_all"] = [t["name"] for t in P["suites"].all_tests(
            "cockroach", opts, P["cockroach"].workloads(opts))]
    assert PORT["_all"] == REF["_all"]


def test_nemesis_cycle_ops_equal_the_references():
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        G = P["gen"]
        h = simulate(G, G.nemesis(G.limit(6, P["suites"].nemesis_cycle(
            0.01))), perfect, concurrency=2)
        got[name] = [(o["type"], o.get("f"), o["time"]) for o in h]
    assert got["port"] == got["ref"]
    assert [f for ty, f, _ in got["port"] if ty == "info"] == \
        ["start", "stop", "start"]


# ---------------------------------------------------------------------------
# The new workloads: generators op for op, checkers on the same histories
# ---------------------------------------------------------------------------

WORKLOAD_GENS = {
    "set": lambda P: P["set"].test(n=20)["generator"],
    "monotonic": lambda P: P["monotonic"].workload()["generator"],
    "sequential": lambda P: P["causal_reverse"].workload(
        NODES, per_key_limit=12)["generator"],
    "g2": lambda P: P["adya"].workload()["generator"],
    "comments": lambda P: P["comments"].workload({"nodes": NODES})[
        "generator"],
}


@pytest.mark.parametrize("workload", sorted(WORKLOAD_GENS))
@pytest.mark.parametrize("completion", ["perfect", "imperfect"])
@pytest.mark.parametrize("seed", [0, 1])
def test_workload_generator_ops_equal_the_references(workload, completion,
                                                     seed):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        random.seed(seed)
        G = P["gen"]
        fn = perfect if completion == "perfect" else make_imperfect()
        h = simulate(G, G.limit(60, G.clients(WORKLOAD_GENS[workload](P))),
                     fn, concurrency=6, test={"nodes": NODES})
        got[name] = [{k: (["tuple", v.key, v.value]
                          if P["ind"].is_tuple(v) else v)
                      for k, v in o.items()} for o in h]
    assert got["port"] == got["ref"]
    assert len(got["port"]) >= 40


def histories(P) -> dict:
    """Hand histories of each new workload's checker, valid and not
    (the reference's own cases, tests/test_suites.py,
    tests/test_workloads_extra.py and tests/test_sql_client.py)."""
    t = P["ind"].tuple_
    inc = [{"type": "invoke", "process": 0, "f": "inc", "value": None},
           {"type": "ok", "process": 0, "f": "inc", "value": 5}]
    mono = {
        "regression": inc + [
            {"type": "invoke", "process": 1, "f": "read", "value": None},
            {"type": "ok", "process": 1, "f": "read", "value": 3}],
        "lost": inc + [
            {"type": "invoke", "process": 1, "f": "inc", "value": None},
            {"type": "ok", "process": 1, "f": "inc", "value": 5}],
        "floor": inc + [
            {"type": "invoke", "process": 1, "f": "read", "value": None},
            {"type": "ok", "process": 1, "f": "read", "value": 5}]}

    def w(v, ty, p=0):
        return {"type": ty, "f": "write", "value": v, "process": p}

    def rd(seen, p=1):
        return {"type": "ok", "f": "read", "value": seen, "process": p}

    seq = [w(0, "invoke"), w(0, "ok"), w(1, "invoke"), w(1, "ok")]
    conc = [w(0, "invoke"), w(1, "invoke"), w(0, "ok"), w(1, "ok")]
    order = {"good": seq + [rd([0, 1]), rd([0]), rd([])],
             "missing": seq + [rd([1])], "concurrent": conc + [rd([1])]}
    ins = [{"type": "invoke", "f": "insert", "process": 0,
            "value": t(1, [10, None])},
           {"type": "ok", "f": "insert", "process": 0,
            "value": t(1, [10, None])},
           {"type": "invoke", "f": "insert", "process": 1,
            "value": t(2, [None, 11])},
           {"type": "ok", "f": "insert", "process": 1,
            "value": t(2, [None, 11])}]
    g2 = {"one-a-key": ins,
          "double": ins + [{"type": "invoke", "f": "insert", "process": 2,
                            "value": t(1, [None, 12])},
                           {"type": "ok", "f": "insert", "process": 2,
                            "value": t(1, [None, 12])}]}
    adds = [o for v in range(4) for o in (
        {"type": "invoke", "f": "add", "value": v, "process": v},
        {"type": "ok" if v != 2 else "info", "f": "add", "value": v,
         "process": v})]
    sets = {"all": adds + [{"type": "invoke", "f": "read", "process": 9},
                           {"type": "ok", "f": "read", "process": 9,
                            "value": [0, 1, 3]}],
            "lost": adds + [{"type": "invoke", "f": "read", "process": 9},
                            {"type": "ok", "f": "read", "process": 9,
                             "value": [0, 3]}]}
    return {("monotonic", k): h for k, h in mono.items()} \
        | {("causal_reverse", k): h for k, h in order.items()} \
        | {("comments", k): h for k, h in order.items()} \
        | {("adya", k): h for k, h in g2.items()} \
        | {("set", k): h for k, h in sets.items()}


def checker_of(P, mod: str):
    if mod == "adya":
        return P["adya"].g2_checker()
    if mod == "comments":
        return P["comments"].CommentsChecker()
    if mod == "set":
        return P["set"].test(n=4)["checker"]
    return P[mod].checker()


@pytest.mark.parametrize("case", sorted(histories(PORT)),
                         ids=lambda c: "-".join(c))
def test_workload_checkers_equal_the_references(case):
    mod, _ = case
    got = {name: checker_of(P, mod).check(
        {"name": "t"}, histories(P)[case], {})
        for name, P in (("ref", REF), ("port", PORT))}
    assert json.dumps(got["port"], sort_keys=True, default=str) == \
        json.dumps(got["ref"], sort_keys=True, default=str)
    want_valid = case[1] in ("floor", "good", "concurrent", "one-a-key",
                             "all")
    assert got["port"]["valid?"] is want_valid


def test_sequential_checker_omits_the_perf_plots():
    """The port's sequential workload composes the reference's checks,
    its latency and rate plots (`perf`) included: none is omitted any
    more (tests/test_torch_plots.py holds the plots to the
    reference's)."""
    port = port_causal_reverse.workload(NODES)["checker"]
    ref = ref_causal_reverse.workload(NODES)["checker"]
    assert sorted(port.checker_map) == sorted(ref.checker_map) == \
        ["perf", "sequential"]


def test_monotonic_workload_full_run(tmp_path):
    """The reference's full matrix run with an in-process counter, on
    the port (tests/test_suites.py)."""
    from jepsen_tpu_torch import client as jclient, db as jdb
    counter = {"v": 0}
    lock = threading.Lock()

    class CounterClient(jclient.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            with lock:
                if op["f"] == "inc":
                    counter["v"] += 1
                return {**op, "type": "ok", "value": counter["v"]}

    std = port_suites.standard_workloads()
    t = port_suites.suite_test(
        "itest", "monotonic",
        port_suites.base_opts(nodes=["n1"], concurrency=4,
                              **{"time-limit": 2}),
        std, db=None, client=CounterClient())
    t.update({"ssh": {"dummy": True}, "net": port_net.noop(),
              "store": Store(tmp_path / "store"), "db": jdb.noop(),
              "generator": port_gen.clients(port_gen.limit(
                  300, std["monotonic"]()["generator"]))})
    t = port_core.run(t)
    assert t["results"]["valid?"] is True
    assert t["results"]["error-count"] == 0


# ---------------------------------------------------------------------------
# The CLI's --device and --faults
# ---------------------------------------------------------------------------

def test_device_flag_reaches_the_test_map_only_when_given():
    p = argparse.ArgumentParser()
    cli.add_test_opts(p)
    cli.add_device_opt(p)
    assert cli.test_map_from_args(p.parse_args(["--device", "cpu"]))[
        "device"] == "cpu"
    assert "device" not in cli.test_map_from_args(p.parse_args([]))
    with pytest.raises(SystemExit):
        p.parse_args(["--device", "tpu"])


@pytest.mark.parametrize("command,want", [
    ("test", "invalid choice: 'tpu'"), ("test-all", "invalid choice: 'tpu'"),
    ("analyze", "unrecognized arguments: --device")])
def test_device_flag_belongs_to_test_and_test_all(command, want, capsys):
    """A suite's `test` and `test-all` know `--device cuda|cpu`;
    `analyze` takes its device from the checker it is handed."""
    assert port_cockroach.main([command, "--device", "tpu"]) == 254
    assert want in capsys.readouterr().err


def test_faults_run_executes_fault_ops(tmp_path):
    """`faults` reaches nemesis_package through the port's suite_test
    (the reference's tests/test_suite_faults.py): a run under
    ["partition"] records start-partition nemesis ops."""
    db, client = workloads.atom_fixtures()
    t = port_suites.suite_test(
        "atom", "reg",
        {"time-limit": 2, "nemesis-interval": 0.3,
         "faults": ["partition"], "nodes": ["n1", "n2", "n3"],
         "concurrency": 3, "ssh": {"dummy": True},
         "extra": {"net": port_net.iptables()}},
        {"reg": lambda: {
            "generator": port_gen.stagger(
                0.02, port_gen.repeat_gen({"f": "read"})),
            "checker": None}},
        db=db, client=client)
    t["store"] = Store(tmp_path / "store")
    t = port_core.run(t)
    fs = {o["f"] for o in t["history"]
          if o.get("process") == "nemesis" and o.get("type") == "info"}
    assert "start-partition" in fs, fs
    assert no_workers_left()


# ---------------------------------------------------------------------------
# Suite runs through run_cli against the fake servers
# ---------------------------------------------------------------------------

SUITE = {"cockroach": (port_cockroach, FakePGServer, "register"),
         "tidb": (port_tidb, FakeMySQLServer, "append")}


def fake_hosts(srv) -> dict:
    return {n: ("127.0.0.1", srv.port) for n in ("n1", "n2", "n3", "n4",
                                                 "n5")}


def on_the_fakes(t: dict, remote) -> dict:
    """A suite's test map made ready for the fake servers, as the
    reference's fake-server helper makes it but keeping the nemesis:
    no daemons to install (db and os go; the fault package still holds
    the suite's DB), the iptables net so partitions reach the remote,
    and the caller's dummy remote."""
    t.pop("db", None)
    t.pop("os", None)
    t["net"] = port_net.iptables()
    t["remote"] = remote
    return t


def run_suite_cli(suite: str, srv, argv: list, limit: float,
                  interval: float, remote, maps: list | None = None):
    """The suite's main's `run_cli` call with a test_fn that adds the
    fakes' hosts, the time limit and the nemesis interval; returns
    (exit code, its JSON lines)."""
    mod, _, default = SUITE[suite]
    make = getattr(mod, f"{suite}_test")
    extra = {"db-hosts": fake_hosts(srv), "time-limit": limit,
             "nemesis-interval": interval}

    def test_fn(tmap, args):
        t = on_the_fakes(make({**tmap, **extra, "workload":
                               port_suites.resolve_workload(args, tmap,
                                                            default)}),
                         remote)
        if maps is not None:
            maps.append(t)
        return t

    def tests_fn(tmap, args):
        out = [on_the_fakes(make({**tmap, **extra, "workload": w}), remote)
               for w in sorted(mod.workloads())]
        if maps is not None:
            maps.extend(out)
        return out

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.run_cli(test_fn, name=suite, tests_fn=tests_fn,
                         opt_fn=lambda p: p.add_argument(
                             "--workload", default=None,
                             choices=sorted(mod.workloads())),
                         argv=argv)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]


def ref_recheck(suite: str, run: Path, tmp_path: Path, workload: str,
                monkeypatch):
    """The reference's `analyze --backend cpu` of a copy of a stored run
    with the reference suite's checker for the workload; returns (exit
    code, results); the bank checker's results hold its balance plot's
    entry in both packages. Its CLI exports JEPSEN_TPU_BACKEND for the
    rest of the process: set here first, the test's teardown undoes
    it."""
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "cpu")
    dst = tmp_path / "ref" / run.parent.name / run.name
    shutil.copytree(run, dst)
    check = REF[suite].workloads({})[workload]()["checker"]
    with contextlib.redirect_stdout(io.StringIO()):
        rc = ref_cli.run_cli(lambda t, a: {**t, "checker": check},
                             argv=["analyze", str(dst), "--store",
                                   str(tmp_path / "ref"), "--backend",
                                   "cpu"])
    res = json.loads((dst / "results.json").read_text())
    return rc, res


@pytest.mark.parametrize("suite,faults", [
    ("tidb", "partition,kill,pause,clock"),
    ("cockroach", "partition,clock"),
    ("cockroach", "partition")])
def test_suite_under_faults_equals_the_references_verdict(
        suite, faults, tmp_path, reference_env, monkeypatch):
    """A suite's `test --dummy --faults ... --device cpu` through
    run_cli: every asked family's ops in the history, their commands
    and the helpers' uploads on the dummy remote, the verdict the
    reference's on the stored run."""
    _, Server, default = SUITE[suite]
    remote = port_control.DummyRemote()
    before = set(threading.enumerate())
    with Server() as srv:
        rc, lines = run_suite_cli(
            suite, srv, ["test", "--dummy", "--faults", faults, "--device",
                         "cpu", "--store", str(tmp_path / "port"),
                         "--concurrency", "5"], 3.0, 0.3, remote)
    assert no_workers_left()
    assert no_threads_left(before)
    assert rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True
    run = Path(lines[0]["dir"])
    hist = [json.loads(ln) for ln in
            (run / "history.jsonl").read_text().splitlines()]
    fs = {o["f"] for o in hist if o["process"] == "nemesis"
          and o["type"] == "info"}
    for family in faults.split(","):
        assert fs & FAMILY_FS[family], (family, fs)
    assert fs <= set().union(*(FAMILY_FS[f] for f in faults.split(",")))
    cmds = " ".join(p for _n, k, p in remote.actions if k == "execute")
    assert "iptables" in cmds
    if "kill" in faults:
        assert "kill -KILL" in cmds and "kill -STOP" in cmds \
            and "kill -CONT" in cmds
        assert "grep /opt/tidb/bin" in cmds
    if "clock" in faults:
        ups = [p[0] for _n, k, p in remote.actions if k == "upload"]
        native = (Path(port_suites.__file__).parent.parent
                  / "native").resolve()
        assert ups and all(Path(u).resolve().parent == native for u in ups)
        assert "g++ -O2 -o /opt/jepsen/bump-time" in cmds
    stored = json.loads((run / "test.json").read_text())
    assert stored["faults"] == faults.split(",")
    assert stored["device"] == "cpu"
    ref_rc, ref_res = ref_recheck(suite, run, tmp_path, default,
                                  monkeypatch)
    res = json.loads((run / "results.json").read_text())
    assert (res["valid?"], res.get("anomaly-types")) == \
        (ref_res["valid?"], ref_res.get("anomaly-types"))
    assert ref_rc == rc
    if suite == "cockroach":
        assert {k: r["valid?"] for k, r in res["results"].items()} == \
            {k: r["valid?"] for k, r in ref_res["results"].items()}


def test_cockroach_test_all_equals_the_references_verdicts(
        tmp_path, reference_env, monkeypatch):
    """`test-all` over cockroach's seven workloads: a line each, each
    stored run re-checked by the reference's checker with the same
    valid?, and the worst code."""
    remote = port_control.DummyRemote()
    with FakePGServer() as srv:
        rc, lines = run_suite_cli(
            "cockroach", srv, ["test-all", "--dummy", "--device", "cpu",
                               "--store", str(tmp_path / "port"),
                               "--concurrency", "5"], 1.0, 10, remote)
    assert no_workers_left()
    names = sorted(port_cockroach.workloads())
    assert [ln["name"] for ln in lines] == [f"cockroach {w}" for w in names]
    codes = []
    for w, ln in zip(names, lines):
        run = Path(ln["dir"])
        res = json.loads((run / "results.json").read_text())
        _, ref_res = ref_recheck("cockroach", run, tmp_path, w,
                                 monkeypatch)
        assert res["valid?"] == ref_res["valid?"] == ln["valid?"], w
        # each composed entry (bank's plot, sequential's perf) too
        assert {k: v["valid?"] for k, v in res.items()
                if isinstance(v, dict) and "valid?" in v} == \
            {k: v["valid?"] for k, v in ref_res.items()
             if isinstance(v, dict) and "valid?" in v}, w
        codes.append(cli.validity_exit_code(res))
    assert rc == max(codes)


def test_default_suite_map_without_a_card_exits_255(tmp_path, monkeypatch,
                                                    capsys):
    """No `--device`: tidb append's checker is the device path; without
    a card the analysis raises DeviceUnavailable, the history stays
    stored, no verdict is written, and `test` exits 255."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("JEPSEN_TPU_BACKEND", raising=False)
    remote = port_control.DummyRemote()
    with FakeMySQLServer() as srv:
        rc, lines = run_suite_cli(
            "tidb", srv, ["test", "--dummy", "--store", str(tmp_path)],
            1.0, 10, remote)
    assert rc == 255 and lines == []
    assert "no CUDA device is available" in capsys.readouterr().err
    (run,) = [p for p in (tmp_path / "tidb append").iterdir()
              if not p.is_symlink()]
    assert (run / "history.jsonl").stat().st_size > 0
    assert not (run / "results.json").exists()
    assert "device" not in json.loads((run / "test.json").read_text())
    assert no_workers_left()


def test_plain_and_faulted_maps_differ_only_in_the_nemesis():
    """`--faults` swaps the suite's nemesis and schedule for the
    package's and nothing else; `nemesis: None` in `extra` would drop
    the package again (the reference's fake-server helper does that)."""
    plain = port_tidb.tidb_test({"time-limit": 1})
    faulted = port_tidb.tidb_test({"time-limit": 1,
                                   "faults": ["partition", "kill"]})
    assert set(faulted) - set(plain) == {"faults"}
    assert faulted["nemesis"].fs == {"start-partition", "stop-partition",
                                     "start-kill", "stop-kill"}
    dropped = port_tidb.tidb_test({"time-limit": 1, "faults": ["kill"],
                                   "extra": {"nemesis": None}})
    assert dropped["nemesis"] is None
    assert isinstance(port_tidb.tidb_test({"time-limit": 1,
                                           "faults": ["kill"]})["nemesis"],
                      type(faulted["nemesis"]))
    assert not isinstance(faulted["nemesis"], NoopNemesis)

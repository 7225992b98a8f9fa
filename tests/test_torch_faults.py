"""The port's fault bundle against the reference's: `nemesis/combined.py`
(the `--faults` packages), `nemesis/clock.py`, `faketime.py`,
`faultfs.py` and their node-side C sources.

- Op for op under a seeded `random`: `db_nodes`, the packages' generator
  ops under the generator simulation, the composed nemesis's routing,
  the dummy remote's action logs of the nemeses invoked on the same
  ops, `faketime.script`/`rand_factor`, and faultfs's routing.
- Byte for byte: the port's four native sources (uploaded to DB nodes
  and compiled there) against the reference's.
- The reference's own tests of these modules (`tests/test_nemesis.py`'s
  combined-package tests, `tests/test_suite_faults.py`,
  `tests/test_faults_native.py`), run on the port.
"""

import os
import random
import subprocess
from pathlib import Path

import pytest

import jepsen_tpu.control as ref_control
import jepsen_tpu.control.net as ref_cnet
import jepsen_tpu.db as ref_db
import jepsen_tpu.faketime as ref_faketime
import jepsen_tpu.faultfs as ref_faultfs
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.net as ref_net
import jepsen_tpu.nemesis as ref_nemesis
import jepsen_tpu.nemesis.clock as ref_clock
import jepsen_tpu.nemesis.combined as ref_combined
import jepsen_tpu.suites.cockroach as ref_cockroach
import jepsen_tpu.suites.tidb as ref_tidb
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.control.net as port_cnet
import jepsen_tpu_torch.db as port_db
import jepsen_tpu_torch.faketime as port_faketime
import jepsen_tpu_torch.faultfs as port_faultfs
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.net as port_net
import jepsen_tpu_torch.nemesis as port_nemesis
import jepsen_tpu_torch.nemesis.clock as port_clock
import jepsen_tpu_torch.nemesis.combined as port_combined
import jepsen_tpu_torch.suites.cockroach as port_cockroach
import jepsen_tpu_torch.suites.tidb as port_tidb
from test_torch_generator import perfect_info, simulate

REPO = Path(__file__).resolve().parent.parent
PORT_NATIVE = REPO / "jepsen_tpu_torch" / "native"
REF_NATIVE = REPO / "native"
SOURCES = ("bump_time.cc", "strobe_time.cc", "faketime_shim.cc",
           "faultfs.cc")
NODES = ["n1", "n2", "n3", "n4", "n5"]
FAMILIES = ("partition", "kill", "pause", "clock")

REF = dict(control=ref_control, cnet=ref_cnet, db=ref_db,
           faketime=ref_faketime, faultfs=ref_faultfs, gen=ref_gen,
           net=ref_net,
           nemesis=ref_nemesis, clock=ref_clock, combined=ref_combined,
           cockroach=ref_cockroach, tidb=ref_tidb)
PORT = dict(control=port_control, cnet=port_cnet, db=port_db,
            faketime=port_faketime, faultfs=port_faultfs, gen=port_gen,
            net=port_net,
            nemesis=port_nemesis, clock=port_clock, combined=port_combined,
            cockroach=port_cockroach, tidb=port_tidb)


def dummy_test(P, nodes=NODES, **kw) -> dict:
    return {"nodes": list(nodes), "ssh": {"dummy": True}, **kw}


def killable_db(P):
    """A DB with the kill and pause protocols that records its calls."""
    class KillableDB(P["db"].DB, P["db"].Process, P["db"].Pause):
        def __init__(self):
            self.events = []

        def start(self, test, node):
            self.events.append(("start", node))

        def kill(self, test, node):
            self.events.append(("kill", node))

        def pause(self, test, node):
            self.events.append(("pause", node))

        def resume(self, test, node):
            self.events.append(("resume", node))

    return KillableDB()


def primary_db(P):
    class PrimaryDB(P["db"].DB, P["db"].Primary):
        def primaries(self, test):
            return ["n4"]

    return PrimaryDB()


def by_node(actions: list) -> dict:
    """The dummy remote's actions per node, in each node's order (nodes
    run in threads of their own, so only that order is fixed). An
    upload's local path is cut to its file name: each package uploads
    its own copy."""
    out: dict = {}
    for node, kind, payload in actions:
        if kind == "upload":
            payload = (os.path.basename(payload[0]), payload[1])
        out.setdefault(node, []).append((kind, payload))
    return out


def uploads(actions: list) -> list:
    return [p[0] for _n, k, p in actions if k == "upload"]


# ---------------------------------------------------------------------------
# The node-side sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SOURCES)
def test_native_sources_are_byte_copies(name):
    assert (PORT_NATIVE / name).read_bytes() == \
        (REF_NATIVE / name).read_bytes()


@pytest.mark.parametrize("mod", [port_clock, port_faketime, port_faultfs],
                         ids=["clock", "faketime", "faultfs"])
def test_native_dir_is_the_ports_own(mod):
    assert Path(mod.NATIVE_DIR).resolve() == PORT_NATIVE


# ---------------------------------------------------------------------------
# combined: db_nodes, the packages' generators and routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["one", "minority", "majority", "all",
                                  "primaries", ["n2", "n4"]],
                         ids=str)
@pytest.mark.parametrize("db", [None, "primary", "killable"])
@pytest.mark.parametrize("seed", [0, 7])
def test_db_nodes_picks_equal_the_references(spec, db, seed):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        d = {None: lambda P: None, "primary": primary_db,
             "killable": killable_db}[db](P)
        random.seed(seed)
        got[name] = [P["combined"].db_nodes(dummy_test(P), d, spec)
                     for _ in range(6)]
    assert got["port"] == got["ref"]


def package_history(P, faults, seed: int, n_ops: int = 24) -> list:
    """The nemesis ops a package's generator gives under the generator
    simulation (every op completes :info in 10 ms), the times removed."""
    random.seed(seed)
    pkg = P["combined"].nemesis_package(killable_db(P), 0.001,
                                        faults=faults)
    G = P["gen"]
    h = simulate(G, G.nemesis(G.limit(n_ops, pkg["generator"])),
                 perfect_info, concurrency=2, test={"nodes": list(NODES)})
    return [{k: v for k, v in o.items() if k != "time"} for o in h]


@pytest.mark.parametrize("faults", [[f] for f in FAMILIES]
                         + [list(FAMILIES), ["partition", "clock"]],
                         ids=lambda fs: "+".join(fs))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_package_generator_ops_equal_the_references(faults, seed):
    ref = package_history(REF, faults, seed)
    port = package_history(PORT, faults, seed)
    assert port == ref
    assert len(port) == 2 * 24


def routes(P, nem) -> dict:
    """{outer f: (the child nemesis's class, the inner f)} of a composed
    nemesis, recursively."""
    out = {}
    for router, child in nem.children.items():
        for f in router:
            inner = router[f] if isinstance(router, dict) else f
            if isinstance(child, P["nemesis"].Compose):
                out[f] = routes(P, child)[inner]
            else:
                out[f] = (type(child).__name__, inner)
    return out


@pytest.mark.parametrize("faults", [list(FAMILIES), ["kill", "pause"],
                                    ["partition"], ["clock"]],
                         ids=lambda fs: "+".join(fs))
def test_fs_routing_equals_the_references(faults):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        pkg = P["combined"].nemesis_package(killable_db(P), 1,
                                            faults=faults)
        got[name] = (sorted(pkg["nemesis"].fs), routes(P, pkg["nemesis"]),
                     pkg["perf"])
    assert got["port"] == got["ref"]


def test_packages_drop_faults_the_db_cannot_take():
    """kill and pause compose in only for the port's own Process/Pause
    classes: a DB of the reference's classes takes none."""
    pkg = port_combined.nemesis_package(killable_db(REF), 1,
                                        faults=["kill", "pause"])
    assert isinstance(pkg["nemesis"], port_nemesis.NoopNemesis)
    assert pkg["generator"] is None
    pkg = port_combined.nemesis_package(killable_db(PORT), 1,
                                        faults=["kill", "pause"])
    assert pkg["nemesis"].fs == {"start-kill", "stop-kill", "start-pause",
                                 "stop-pause"}


def test_compose_packages_refuses_overlapping_fs():
    for P in (REF, PORT):
        C = P["combined"]
        with pytest.raises(ValueError, match="routed to two packages"):
            C.compose_packages([C.kill_package(killable_db(P), 1),
                                C.kill_package(killable_db(P), 1)])


# ---------------------------------------------------------------------------
# The nemeses against the dummy remote
# ---------------------------------------------------------------------------

def cockroach_db(P):
    return P["cockroach"].CockroachDB()


def run_ops(P, nem, ops: list, seed: int, **test_kw) -> tuple:
    """Set the nemesis up and invoke `ops` on a dummy test with the
    iptables net; returns (completions, the remote's actions). The
    nodes' IPs are resolved afresh (`control.net` memoizes them per
    process)."""
    random.seed(seed)
    P["cnet"].clear_ip_cache()
    test = dummy_test(P, net=P["net"].iptables(), **test_kw)
    remote = P["control"].remote_for(test)
    nem = nem.setup(test)
    outs = [nem.invoke(test, {"type": "info", "process": "nemesis", **op})
            for op in ops]
    nem.teardown(test)
    return outs, remote.actions


DB_OPS = [{"f": "start-kill", "value": "one"}, {"f": "stop-kill"},
          {"f": "start-kill", "value": "majority"}, {"f": "stop-kill"},
          {"f": "start-pause", "value": "all"}, {"f": "stop-pause"},
          {"f": "start-pause", "value": "minority"}, {"f": "stop-pause"}]


@pytest.mark.parametrize("db", ["cockroach", "tidb"])
@pytest.mark.parametrize("seed", [4, 5])
def test_db_nemesis_actions_equal_the_references(db, seed):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        d = (P["cockroach"].CockroachDB() if db == "cockroach"
             else P["tidb"].TiDB())
        outs, actions = run_ops(P, P["combined"].DBNemesis(d), DB_OPS, seed)
        got[name] = (outs, by_node(actions))
    assert got["port"] == got["ref"]
    cmds = " ".join(p for acts in got["port"][1].values()
                    for k, p in acts if k == "execute")
    for sig in ("kill -KILL", "kill -STOP", "kill -CONT"):
        assert sig in cmds


def clock_ops(P, seed: int) -> list:
    random.seed(seed)
    test = {"nodes": list(NODES)}
    C = P["clock"]
    return [C.bump_gen(test, None), C.strobe_gen(test, None),
            C.reset_gen(), {"f": "reset", "value": ["n2"]},
            C.bump_gen(test, None)]


@pytest.mark.parametrize("seed", [0, 9])
def test_clock_nemesis_actions_equal_the_references(seed):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        ops = clock_ops(P, seed)
        outs, actions = run_ops(P, P["clock"].clock_nemesis(), ops, seed)
        got[name] = (ops, outs, by_node(actions))
        if P is PORT:
            srcs = uploads(actions)
    assert got["port"] == got["ref"]
    # the uploads are the port's own copies of the helpers
    assert sorted(set(srcs)) == [
        str(Path(port_clock.NATIVE_DIR) / f"{h}.cc")
        for h in ("bump_time", "strobe_time")]
    assert all(Path(s).resolve().parent == PORT_NATIVE for s in srcs)
    cmds = " ".join(p for acts in got["port"][2].values()
                    for k, p in acts if k == "execute")
    assert "bump-time" in cmds and "strobe-time" in cmds
    assert "ntpdate" in cmds


@pytest.mark.parametrize("seed", [0, 3])
def test_partition_package_actions_equal_the_references(seed):
    """The package's own generator ops (grudges drawn from the seed)
    invoked on its nemesis over the iptables net."""
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        invokes = package_history(P, ["partition"], seed, n_ops=6)[::2]
        ops = [{"f": o["f"], "value": o["value"]} for o in invokes]
        pkg = P["combined"].partition_package(interval=1)
        outs, actions = run_ops(P, pkg["nemesis"], ops, seed)
        got[name] = (ops, outs, by_node(actions))
    assert got["port"] == got["ref"]
    cmds = [p for acts in got["port"][2].values() for k, p in acts
            if k == "execute"]
    assert any("iptables" in c for c in cmds)


def test_clock_scrambler_commands():
    """The scrambler's draws happen on the nodes' threads, so only the
    commands' shape is compared."""
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        test = dummy_test(P, nodes=["n1", "n2"])
        remote = P["control"].remote_for(test)
        nem = P["clock"].clock_scrambler(30)
        out = nem.invoke(test, {"type": "info", "f": "scramble"})
        nem.teardown(test)
        got[name] = (sorted(out["value"]),
                     sorted(p.split("@")[0] for _n, k, p in remote.actions
                            if k == "execute"))
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# The reference's combined-package tests (tests/test_nemesis.py), on the port
# ---------------------------------------------------------------------------

def test_nemesis_package_composition():
    db = killable_db(PORT)
    pkg = port_combined.nemesis_package(db=db, interval=0.001,
                                        faults=("partition", "kill"))
    assert pkg["nemesis"].fs >= {"start-partition", "stop-partition",
                                 "start-kill", "stop-kill"}


def test_package_generator_alternates():
    pkg = port_combined.partition_package(interval=0.001)
    h = simulate(port_gen, port_gen.nemesis(port_gen.limit(
        6, pkg["generator"])), perfect_info, concurrency=2,
        test={"nodes": list(NODES)})
    fs = [o["f"] for o in h]
    assert fs == (["start-partition"] * 2 + ["stop-partition"] * 2) * 3


def test_db_nemesis_kills_targets():
    db = killable_db(PORT)
    test = dummy_test(PORT)
    n = port_combined.DBNemesis(db)
    random.seed(1)
    res = n.invoke(test, {"f": "start-kill", "value": "majority"})
    assert res["type"] == "info"
    assert len([e for e in db.events if e[0] == "kill"]) == 3
    n.invoke(test, {"f": "stop-kill", "value": None})
    assert len([e for e in db.events if e[0] == "start"]) == 5


def test_db_nodes_specs():
    test = dummy_test(PORT)
    C = port_combined
    assert len(C.db_nodes(test, None, "one")) == 1
    assert len(C.db_nodes(test, None, "minority")) == 2
    assert len(C.db_nodes(test, None, "majority")) == 3
    assert C.db_nodes(test, None, "all") == NODES
    assert C.db_nodes(test, None, ["n2"]) == ["n2"]


@pytest.fixture(scope="module")
def built_helpers(tmp_path_factory):
    """The port's clock helpers, compiled as a node compiles them."""
    d = tmp_path_factory.mktemp("native")
    bins = {}
    for name in port_clock.HELPERS:
        out = d / name
        r = subprocess.run(
            ["g++", "-O2", "-o", str(out),
             str(Path(port_clock.NATIVE_DIR) / f"{name}.cc")],
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        bins[name] = str(out)
    return bins


def test_native_helpers_compile(built_helpers):
    assert len(built_helpers) == 2


# ---------------------------------------------------------------------------
# The reference's tests/test_suite_faults.py, on the port
# ---------------------------------------------------------------------------

def test_suite_test_builds_combined_nemesis():
    """The composed package replaces a suite's default nemesis; the
    reference's test uses etcd, which is not ported: cockroach's DB
    supports Process and Pause as etcd's does."""
    C = port_cockroach
    plain = C.cockroach_test({"time-limit": 1})
    t = C.cockroach_test({"time-limit": 1,
                          "faults": ["partition", "kill", "pause"]})
    assert type(t["nemesis"]) is not type(plain["nemesis"])
    kill_only = C.cockroach_test({"time-limit": 1, "faults": ["kill"]})
    assert not isinstance(kill_only["nemesis"], port_nemesis.NoopNemesis)
    assert kill_only["nemesis"].fs == {"start-kill", "stop-kill"}
    ref = ref_cockroach.cockroach_test({"time-limit": 1,
                                        "faults": ["partition", "kill",
                                                   "pause", "clock"]})
    port = C.cockroach_test({"time-limit": 1,
                             "faults": ["partition", "kill", "pause",
                                        "clock"]})
    assert routes(PORT, port["nemesis"]) == routes(REF, ref["nemesis"])


def test_cli_faults_flag_parses():
    import argparse
    from jepsen_tpu_torch import cli
    p = argparse.ArgumentParser()
    cli.add_test_opts(p)
    args = p.parse_args(["--faults", "partition, kill"])
    assert cli.test_map_from_args(args)["faults"] == ["partition", "kill"]
    assert "faults" not in cli.test_map_from_args(p.parse_args([]))


@pytest.mark.parametrize("suite", ["cockroach", "tidb"])
def test_signal_process_dbs_support_kill_pause(suite):
    """The suites' DBs implement the port's Process and Pause, and
    their signals reach the node as the reference's do."""
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        db = (P["cockroach"].CockroachDB() if suite == "cockroach"
              else P["tidb"].TiDB())
        assert isinstance(db, P["db"].Process), type(db).__name__
        assert isinstance(db, P["db"].Pause), type(db).__name__
        test = {"nodes": ["n1"], "ssh": {"dummy": True}}
        remote = P["control"].remote_for(test)
        with P["control"].bind_session(P["control"].session(test, "n1")):
            db.kill(test, "n1")
            db.pause(test, "n1")
            db.resume(test, "n1")
            db.start(test, "n1")
        got[name] = [p for _, k, p in remote.actions if k == "execute"]
    assert got["port"] == got["ref"]
    cmds = " || ".join(got["port"])
    assert "kill -KILL" in cmds
    assert "kill -STOP" in cmds and "kill -CONT" in cmds


@pytest.mark.parametrize("suite", ["cockroach", "tidb"])
def test_kill_pause_packages_compose_for_signal_dbs(suite):
    db = (port_cockroach.CockroachDB() if suite == "cockroach"
          else port_tidb.TiDB())
    pkg = port_combined.nemesis_package(db, 5, faults=["kill", "pause"])
    assert pkg["generator"] is not None
    assert isinstance(pkg["nemesis"].children[
        frozenset({"start-kill", "stop-kill"})], port_combined.DBNemesis)


# ---------------------------------------------------------------------------
# faketime (tests/test_faults_native.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmd,offset,rate", [
    ("/usr/bin/db-server", -30, 1.5), ("/opt/x/bin/y", 0, 1),
    ("db", 7200.5, 0.25)])
def test_script_equals_the_references(cmd, offset, rate):
    s = port_faketime.script(cmd, offset, rate)
    assert s == ref_faketime.script(cmd, offset, rate)
    assert port_faketime.SHIM_SO == ref_faketime.SHIM_SO


def test_script_contents():
    s = port_faketime.script("/usr/bin/db-server", -30, 1.5)
    assert s.startswith("#!/bin/bash\n")
    assert f"LD_PRELOAD={port_faketime.SHIM_SO}" in s
    assert "JEPSEN_FAKETIME_OFFSET_S=-30.0" in s
    assert "JEPSEN_FAKETIME_RATE=1.5" in s
    assert 'exec /usr/bin/db-server "$@"' in s


@pytest.mark.parametrize("factor", [1.0, 2.5, 10.0])
@pytest.mark.parametrize("seed", [0, 11])
def test_rand_factor_equals_the_references(factor, seed):
    for rng in (True, False):
        got = {}
        for name, mod in (("ref", ref_faketime), ("port", port_faketime)):
            random.seed(seed)
            r = random.Random(seed) if rng else None
            got[name] = [mod.rand_factor(factor, r) for _ in range(50)]
        assert got["port"] == got["ref"]


def test_rand_factor_bounds():
    rng = random.Random(0)
    vals = [port_faketime.rand_factor(2.5, rng) for _ in range(500)]
    hi = 2 / (1 + 1 / 2.5)
    lo = hi / 2.5
    assert all(lo <= v <= hi for v in vals)
    assert max(vals) / min(vals) <= 2.5 + 1e-9


@pytest.fixture(scope="module")
def shim_so(tmp_path_factory):
    """The port's copy of the shim, built as `faketime.install` builds
    it on a node (skipped, as the reference's is, when it cannot
    build)."""
    out = tmp_path_factory.mktemp("shim") / "libfaketime_shim.so"
    r = subprocess.run(
        ["g++", "-O2", "-fPIC", "-shared", "-pthread", "-o", str(out),
         str(Path(port_faketime.NATIVE_DIR) / "faketime_shim.cc"), "-ldl"],
        capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"shim build failed: {r.stderr[:200]}")
    return str(out)


def test_shim_offset(shim_so):
    env = dict(os.environ, LD_PRELOAD=shim_so,
               JEPSEN_FAKETIME_OFFSET_S="7200")
    faked = int(subprocess.run(["date", "+%s"], env=env,
                               capture_output=True, text=True).stdout)
    real = int(subprocess.run(["date", "+%s"],
                              capture_output=True, text=True).stdout)
    assert 7190 < faked - real < 7210


def test_shim_rate(shim_so):
    env = dict(os.environ, LD_PRELOAD=shim_so, JEPSEN_FAKETIME_RATE="8")
    out = subprocess.run(
        ["python3", "-c",
         "import time; a=time.time(); time.sleep(0.3); print(time.time()-a)"],
        env=env, capture_output=True, text=True)
    dt = float(out.stdout)
    assert 1.8 < dt < 3.5


def faketime_actions(P, fn) -> list:
    test = {"nodes": ["n1"], "ssh": {"dummy": True}}
    remote = P["control"].remote_for(test)
    P["control"].on_nodes(test, lambda t, n: fn(P))
    return remote.actions


@pytest.mark.parametrize("what", ["wrap-unwrap", "install"])
def test_faketime_actions_equal_the_references(what):
    def act(P):
        if what == "install":
            P["faketime"].install()
        else:
            P["faketime"].wrap("/usr/bin/db", 10, 2.0)
            P["faketime"].unwrap("/usr/bin/db")
    ref = faketime_actions(REF, act)
    port = faketime_actions(PORT, act)
    assert by_node(port) == by_node(ref)
    if what == "install":
        assert uploads(port) == [
            str(Path(port_faketime.NATIVE_DIR) / "faketime_shim.cc")]
    else:
        cmds = [p for _, k, p in port if k == "execute"]
        assert any("JEPSEN_FAKETIME_RATE=2.0" in c for c in cmds)
        assert any("chmod a+x /usr/bin/db" in c for c in cmds)
        assert any("mv /usr/bin/db.no-faketime /usr/bin/db" in c
                   for c in cmds)


# ---------------------------------------------------------------------------
# faultfs (tests/test_faults_native.py)
# ---------------------------------------------------------------------------

def test_faultfs_source_present_and_plausible():
    src = (Path(port_faultfs.NATIVE_DIR) / "faultfs.cc").read_text()
    assert "fuse_main" in src
    assert ".faultfs-ctl" in src


FAULTFS_OPS = [
    {"f": "break-all", "value": None},
    {"f": "break-pct", "value": 0.05},
    {"f": "break-pct", "value": [["n1"], 0.5]},
    {"f": "delay", "value": 2000},
    {"f": "delay", "value": [["n2"], 50]},
    {"f": "clear", "value": ["n2"]},
    {"f": "clear", "value": None},
]


@pytest.mark.parametrize("op", FAULTFS_OPS, ids=lambda o: f"{o['f']}-"
                         f"{type(o['value']).__name__}")
def test_faultfs_routing_equals_the_references(op):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        test = {"nodes": ["n1", "n2"], "ssh": {"dummy": True}}
        remote = P["control"].remote_for(test)
        out = P["faultfs"].nemesis().invoke(test, {"type": "info", **op})
        got[name] = (out, by_node(remote.actions))
    assert got["port"] == got["ref"]


def test_faultfs_nemesis_routing():
    test = {"nodes": ["n1", "n2"], "ssh": {"dummy": True}}
    remote = port_control.remote_for(test)
    nem = port_faultfs.nemesis()
    op = nem.invoke(test, {"type": "info", "f": "break-all", "value": None})
    assert op["type"] == "info"
    cmds = [(n, p) for n, kind, p in remote.actions if kind == "execute"]
    eio = [(n, c) for n, c in cmds
           if "eio 1" in c and port_faultfs.CTL in c]
    assert {n for n, _ in eio} == {"n1", "n2"}
    remote.actions.clear()
    nem.invoke(test, {"type": "info", "f": "break-pct", "value": 0.05})
    assert any("eio 0.05" in c for _, k, c in remote.actions
               if k == "execute")
    remote.actions.clear()
    nem.invoke(test, {"type": "info", "f": "clear", "value": ["n2"]})
    clr = [(n, c) for n, k, c in remote.actions
           if k == "execute" and "clear" in c]
    assert {n for n, _ in clr} == {"n2"}


def test_faultfs_nemesis_setup_installs_everywhere():
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        test = {"nodes": ["n1"], "ssh": {"dummy": True}}
        remote = P["control"].remote_for(test)
        P["faultfs"].nemesis().setup(test)
        got[name] = remote.actions
    assert by_node(got["port"]) == by_node(got["ref"])
    kinds = [(k, p) for _, k, p in got["port"]]
    assert uploads(got["port"]) == [
        str(Path(port_faultfs.NATIVE_DIR) / "faultfs.cc")]
    assert any(k == "execute" and "g++" in str(p) for k, p in kinds)
    assert any(k == "execute" and port_faultfs.MOUNT_DIR in str(p)
               for k, p in kinds)


def test_faultfs_unknown_op_raises():
    test = {"nodes": ["n1"], "ssh": {"dummy": True}}
    port_control.remote_for(test)
    with pytest.raises(ValueError, match="unknown faultfs op"):
        port_faultfs.nemesis().invoke(
            test, {"type": "info", "f": "bogus", "value": None})


@pytest.mark.parametrize("budget", [0, 5, 17, 40, 1000])
def test_faulty_opener_equals_the_references(budget, tmp_path):
    """The byte-budgeted write fault: the same bytes land and the same
    writes raise, across two files sharing the budget."""
    got = {}
    for name, mod in (("ref", ref_faultfs), ("port", port_faultfs)):
        d = tmp_path / name
        d.mkdir()
        opener = mod.faulty_opener(budget)
        errors = []
        for fname, lines in (("a.txt", ["0123456789", "abcdef\n"]),
                             ("b.txt", ["xyz" * 5, "tail\n"])):
            try:
                with opener(d / fname, "w") as f:
                    f.writelines(lines)
            except OSError as e:
                errors.append((fname, e.errno, str(e)))
        with opener(d / "a.txt") as f:
            first = f.read()
        got[name] = (errors, first, {p.name: p.read_bytes()
                                     for p in sorted(d.iterdir())})
    assert got["port"] == got["ref"]

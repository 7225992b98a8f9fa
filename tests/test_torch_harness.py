"""The port's harness layers give the reference's commands and results:
the control plane (DummyRemote's recorded actions, `build_cmd`'s
escaping, the node helpers), the OS and DB lifecycles, the network and
the nemeses, and the bank and long-fork checkers on seeded histories.

Each case drives both packages the same way on their own DummyRemote and
compares what was recorded. `on_nodes` runs a thread per node, so
actions are compared per node, in the order each node saw them.
"""

import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jepsen_tpu.control as ref_control
import jepsen_tpu.control.net as ref_cnet
import jepsen_tpu.control.util as ref_cutil
import jepsen_tpu.db as ref_db
import jepsen_tpu.nemesis as ref_nemesis
import jepsen_tpu.net as ref_net
import jepsen_tpu.os_setup as ref_os
import jepsen_tpu.util as ref_util
import jepsen_tpu.workloads.bank as ref_bank
import jepsen_tpu.workloads.long_fork as ref_long_fork
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.control.net as port_cnet
import jepsen_tpu_torch.control.util as port_cutil
import jepsen_tpu_torch.db as port_db
import jepsen_tpu_torch.nemesis as port_nemesis
import jepsen_tpu_torch.net as port_net
import jepsen_tpu_torch.os_setup as port_os
import jepsen_tpu_torch.util as port_util
import jepsen_tpu_torch.workloads.bank as port_bank
import jepsen_tpu_torch.workloads.long_fork as port_long_fork

NODES = ["n1", "n2", "n3", "n4", "n5"]
PKGS = {
    "ref": dict(control=ref_control, cnet=ref_cnet, cutil=ref_cutil,
                db=ref_db, nemesis=ref_nemesis, net=ref_net, os=ref_os),
    "port": dict(control=port_control, cnet=port_cnet, cutil=port_cutil,
                 db=port_db, nemesis=port_nemesis, net=port_net,
                 os=port_os),
}


def dummy_test(control, nodes=NODES, **kw) -> dict:
    return {"nodes": list(nodes), "ssh": {"dummy": True},
            "remote": control.DummyRemote(), **kw}


def per_node(actions: list) -> dict:
    out: dict = {}
    for node, kind, payload in actions:
        out.setdefault(node, []).append((kind, payload))
    return out


def both(fn):
    """fn(pkg modules) in each package; returns (ref, port) results."""
    return fn(**PKGS["ref"]), fn(**PKGS["port"])


# ---------------------------------------------------------------------------
# control
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(st.text(max_size=12), st.integers(),
                          st.lists(st.text(max_size=6), max_size=3)),
                max_size=6))
def test_build_cmd_escapes_like_the_reference(args):
    assert port_control.build_cmd(*args) == ref_control.build_cmd(*args)
    lit = [port_control.Lit("a | b"), *args]
    assert port_control.build_cmd(*lit) == ref_control.build_cmd(
        ref_control.Lit("a | b"), *args)


def session_script(control, **_):
    """exec, su, cd, upload, download and the implicit session through
    one DummyRemote session; returns the remote's actions and results."""
    remote = control.DummyRemote()
    remote.responses["hostname"] = "n1.example\n"
    sess = control.Session(remote, control.conn_spec(
        {"ssh": {"username": "admin", "port": 2222}}, "n1"))
    out = [sess.exec("echo", "hello world", 3),
           sess.exec("hostname"),
           sess.su().exec("apt-get", "install", "-y", "x y"),
           sess.su("postgres", "pw").cd("/var/lib/pg").exec(
               "ls", "-la", control.Lit("| head -n 1")),
           sess.cd("/tmp dir").exec_ok("rm", "-rf", "*").exit]
    sess.upload("/local/a b", "/remote/c")
    sess.download("/remote/log", "/local/log")
    sess.disconnect()
    with control.bind_session(sess):
        out.append(control.exec("true"))
        out.append(control.sudo_exec("whoami"))
    return remote.actions, out


def test_dummy_remote_records_the_references_actions():
    ref, port = both(session_script)
    assert port == ref
    assert any(kind == "upload" for _, kind, _ in port[0])


def test_on_nodes_binds_a_session_per_node():
    def script(control, **_):
        test = dummy_test(control)
        res = control.on_nodes(
            test, lambda t, node: control.current_session().su().exec(
                "echo", node))
        return res, per_node(test["remote"].actions)
    ref, port = both(script)
    assert port == ref
    with pytest.raises(RuntimeError, match="no control session"):
        port_control.current_session()


def test_remote_for_picks_the_references_backend():
    for control in (ref_control, port_control):
        t = {"ssh": {"dummy": True}}
        r = control.remote_for(t)
        assert isinstance(r, control.DummyRemote) and t["remote"] is r
        mine = control.LocalRemote()
        assert control.remote_for({"remote": mine}) is mine


def node_helpers(control, cutil, **_):
    remote = control.DummyRemote()
    remote.responses["ls -A"] = "pkg-1.0\n"
    sess = control.Session(remote, {"node": "n2"})
    cutil.install_archive(sess, "https://example.invalid/pkg-1.0.tgz",
                          "/opt/pkg")
    cutil.start_daemon(sess, "/opt/pkg/bin/server", "--port", 7000,
                       pidfile="/var/run/s.pid", logfile="/var/log/s.log",
                       chdir="/opt/pkg", env={"A": "b c"})
    cutil.stop_daemon(sess, "/var/run/s.pid")
    cutil.grepkill(sess, "server x")
    cutil.signal(sess, "server", "STOP")
    cutil.ensure_user(sess, "jepsen")
    out = [cutil.exists(sess, "/x"), cutil.daemon_running(sess, "/p"),
           cutil.wget(sess, "https://example.invalid/f.tar?x=1")]
    return remote.actions, out


def test_node_helpers_issue_the_references_commands():
    ref, port = both(node_helpers)
    assert port == ref


def test_control_net_resolves_like_the_reference():
    def script(control, cnet, **_):
        cnet.clear_ip_cache()
        remote = control.DummyRemote()
        remote.responses["getent"] = ("10.0.0.7 STREAM n3\n"
                                      "10.0.0.7 DGRAM\n")
        sess = control.Session(remote, {"node": "n1"})
        out = [cnet.ip(sess, "n3"), cnet.ip(sess, "n3"),
               cnet.local_ip(sess), cnet.reachable(sess, "n3")]
        cnet.clear_ip_cache()
        return remote.actions, out
    ref, port = both(script)
    assert port == ref


# ---------------------------------------------------------------------------
# os_setup, db
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("os_name", ["debian", "centos", "ubuntu",
                                     "smartos", "noop"])
def test_os_setup_commands_equal_the_references(os_name):
    def script(control, cnet, os, **_):
        cnet.clear_ip_cache()
        test = dummy_test(control, nodes=["n1", "n2", "n3"])
        osx = getattr(os, os_name)(("extra-pkg",)) if os_name != "noop" \
            else os.noop()
        control.on_nodes(test, osx.setup)
        control.on_nodes(test, osx.teardown)
        cnet.clear_ip_cache()
        return per_node(test["remote"].actions)
    ref, port = both(script)
    assert port == ref


class _Recorder:
    """A DB that records its lifecycle and fails setup `fails` times."""

    def __init__(self, db, fails: int):
        self.db, self.fails, self.calls = db, fails, []

    def make(self):
        rec = self

        class FlakyDB(rec.db.DB, rec.db.Primary, rec.db.LogFiles):
            def setup(self, test, node):
                rec.calls.append(("setup", node))
                if node == "n1" and rec.fails > 0:
                    rec.fails -= 1
                    raise rec.db.SetupFailed("not yet")

            def teardown(self, test, node):
                rec.calls.append(("teardown", node))

            def setup_primary(self, test, node):
                rec.calls.append(("primary", node))

        return FlakyDB()


@pytest.mark.parametrize("fails", [0, 1, 2, 3])
def test_db_cycle_retries_like_the_reference(fails):
    def script(control, db, **_):
        rec = _Recorder(db, fails)
        test = dummy_test(control, nodes=["n1", "n2"])
        try:
            db.cycle(rec.make(), test)
            outcome = "ok"
        except db.SetupFailed:
            outcome = "failed"
        db.teardown_all(rec.make(), test)
        return outcome, sorted(rec.calls)
    ref, port = both(script)
    assert port == ref
    assert port[0] == ("failed" if fails >= 3 else "ok")


def test_tcpdump_db_commands_equal_the_references():
    def script(control, db, **_):
        test = dummy_test(control, nodes=["n1"])
        tdb = db.TcpdumpDB(db.noop(), [5432, 8080])
        control.on_nodes(test, tdb.setup)
        control.on_nodes(test, tdb.teardown)
        return test["remote"].actions, tdb.log_files(test, "n1")
    ref, port = both(script)
    assert port == ref


# ---------------------------------------------------------------------------
# net, nemesis
# ---------------------------------------------------------------------------

GRUDGES = {
    "halves": lambda N: N.complete_grudge(N.bisect(NODES)),
    "split-one": lambda N: N.complete_grudge(N.split_one(NODES)),
    "split-one-n3": lambda N: N.complete_grudge(N.split_one(NODES, "n3")),
    "bridge": lambda N: N.bridge(NODES),
    "majorities-ring": lambda N: N.majorities_ring(NODES),
}


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("grudge", sorted(GRUDGES))
def test_grudges_equal_the_references(grudge, seed):
    random.seed(seed)
    ref = GRUDGES[grudge](ref_nemesis)
    random.seed(seed)
    assert GRUDGES[grudge](port_nemesis) == ref


@pytest.mark.parametrize("net_name", ["iptables", "ipfilter"])
@pytest.mark.parametrize("grudge", sorted(GRUDGES))
def test_partitioner_net_commands_equal_the_references(grudge, net_name):
    """A Partitioner's start and stop on the iptables or ipfilter net:
    the same commands on each node and the same op values."""
    def script(control, cnet, net, nemesis, **_):
        cnet.clear_ip_cache()
        random.seed(11)
        test = dummy_test(control, net=getattr(net, net_name)())
        nem = nemesis.partitioner(
            lambda nodes: GRUDGES[grudge](nemesis)).setup(test)
        ops = [nem.invoke(test, {"type": "info", "f": f})
               for f in ("start", "stop")]
        nem.teardown(test)
        test["net"].slow(test)
        test["net"].flaky(test)
        test["net"].fast(test)
        cnet.clear_ip_cache()
        return ops, per_node(test["remote"].actions)
    ref, port = both(script)
    assert port == ref


def test_noop_net_records_the_references_grudges():
    def script(control, net, nemesis, **_):
        random.seed(3)
        test = dummy_test(control)
        assert isinstance(net.net_for({"ssh": {"dummy": True}}),
                          net.NoopNet)
        test["net"] = net.noop()
        for make in (nemesis.partition_halves,
                     nemesis.partition_random_halves,
                     nemesis.partition_random_node,
                     nemesis.partition_majorities_ring):
            nem = make().setup(test)
            nem.invoke(test, {"type": "info", "f": "start"})
            nem.invoke(test, {"type": "info", "f": "stop"})
        return test["net"].grudges, test["net"].healed
    ref, port = both(script)
    assert port == ref


def test_compose_routes_and_process_faults_like_the_reference():
    def script(control, nemesis, **_):
        random.seed(9)
        test = dummy_test(control)
        test["net"] = PKGS_NET[control]()
        nem = nemesis.compose({
            frozenset({"start", "stop"}): nemesis.partition_halves(),
            _Router({"pause": "start", "resume": "stop"}):
                nemesis.hammer_time("postgres"),
            frozenset({"truncate"}): nemesis.truncate_file("/var/x.log",
                                                           64),
        }).setup(test)
        ops = [nem.invoke(test, {"type": "info", "f": f, "value": v})
               for f, v in (("start", None), ("pause", None),
                            ("resume", None), ("truncate", ["n2"]),
                            ("stop", None))]
        with pytest.raises(ValueError):
            nem.invoke(test, {"type": "info", "f": "bogus"})
        nem.teardown(test)
        return ops, per_node(test["remote"].actions), sorted(nem.fs)
    ref, port = both(script)
    assert port == ref


class _Router(dict):
    """A dict router that hashes, so it can key `Compose`'s map."""

    def __hash__(self):
        return hash(frozenset(self.items()))


PKGS_NET = {ref_control: ref_net.noop, port_control: port_net.noop}


def test_timeout_nemesis_like_the_reference():
    import threading
    release = threading.Event()

    def script(nemesis, **_):
        class Slow(nemesis.Nemesis):
            def invoke(self, test, op):
                release.wait(2)
                return {**op, "type": "info", "value": "late"}
        nem = nemesis.Timeout(0.05, Slow()).setup({})
        fast = nemesis.Timeout(5, nemesis.noop()).setup({})
        return (nem.invoke({}, {"f": "x", "type": "info"}),
                fast.invoke({}, {"f": "y", "type": "info"}))
    try:
        ref, port = both(script)
    finally:
        release.set()
    assert port == ref
    assert port[0]["value"] == "timeout"


# ---------------------------------------------------------------------------
# util
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(8))
def test_majority_and_minority(n):
    assert (port_util.majority(n), port_util.minority(n)) \
        == (ref_util.majority(n), ref_util.minority(n))


@pytest.mark.parametrize("fails", [0, 2, 5])
def test_with_retry_like_the_reference(fails):
    def attempts(util):
        calls = []

        def f():
            calls.append(1)
            if len(calls) <= fails:
                raise OSError("busy")
            return len(calls)
        try:
            return util.with_retry(f, retries=3), len(calls)
        except OSError:
            return "raised", len(calls)
    assert attempts(port_util) == attempts(ref_util)


def test_relative_time_is_thread_local():
    import threading
    with port_util.relative_time():
        assert port_util.relative_time_nanos() >= 0
        err = []

        def other():
            try:
                port_util.relative_time_nanos()
            except RuntimeError as e:
                err.append(e)
        t = threading.Thread(target=other)
        t.start()
        t.join(5)
        assert not t.is_alive() and err
    with pytest.raises(RuntimeError, match="outside relative_time"):
        port_util.relative_time_nanos()


# ---------------------------------------------------------------------------
# the bank and long-fork checkers
# ---------------------------------------------------------------------------

def bank_history(seed: int, n: int, torn: bool) -> list:
    rng = random.Random(seed)
    bal = {a: 25 for a in range(4)}
    hist = []
    for i in range(n):
        if rng.random() < 0.5:
            a, b = rng.sample(sorted(bal), 2)
            amt = rng.randint(1, 5)
            op = {"process": i % 3, "f": "transfer",
                  "value": {"from": a, "to": b, "amount": amt}}
            hist.append({**op, "type": "invoke"})
            bal[a] -= amt
            if not (torn and rng.random() < 0.1):
                bal[b] += amt
            else:
                bal[b] += amt - 1     # a lost unit: the total drifts
            hist.append({**op, "type": "ok"})
        else:
            op = {"process": i % 3, "f": "read"}
            hist.append({**op, "type": "invoke", "value": None})
            hist.append({**op, "type": "ok", "value": dict(bal)})
    return hist


@pytest.mark.parametrize("torn", [False, True], ids=["sound", "torn"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bank_checker_agrees_with_the_reference(seed, torn):
    hist = bank_history(seed, 200, torn)
    test = {"total-amount": 100}
    for kw in ({}, {"negative_balances": True}):
        ref = ref_bank.checker(**kw).check(test, hist, {})
        port = port_bank.checker(**kw).check(test, hist, {})
        assert port == ref
    assert port["valid?"] is (not torn)


def long_fork_reads(seed: int, n_reads: int, group: int, fork: bool):
    """Reads of one key group that grow as keys are written, in an
    order; with `fork`, one pair of reads sees two keys in opposite
    orders."""
    rng = random.Random(seed)
    keys = list(range(group))
    order = keys[:]
    rng.shuffle(order)
    ops = []
    for i in range(n_reads):
        seen = set(order[:rng.randint(0, group)])
        ops.append({"type": "ok", "f": "read", "process": i,
                    "value": [["r", k, 1 if k in seen else None]
                              for k in keys]})
    if fork:
        a, b = order[0], order[1]
        ops.append({"type": "ok", "f": "read", "process": n_reads,
                    "value": [["r", k, 1 if k == a else None]
                              for k in keys]})
        ops.append({"type": "ok", "f": "read", "process": n_reads + 1,
                    "value": [["r", k, 1 if k == b else None]
                              for k in keys]})
    return ops


@pytest.mark.parametrize("fork", [False, True], ids=["ordered", "fork"])
@pytest.mark.parametrize("n_reads", [10, 100])
def test_find_forks_vectorized_agrees_with_the_reference(n_reads, fork):
    ops = long_fork_reads(n_reads, n_reads, 6, fork)
    ref = ref_long_fork.find_forks_vectorized(ops)
    assert port_long_fork.find_forks_vectorized(ops) == ref
    assert port_long_fork.find_forks(ops) == ref_long_fork.find_forks(ops)
    assert bool(ref) is fork


@pytest.mark.parametrize("fork", [False, True], ids=["ordered", "fork"])
def test_long_fork_checker_agrees_with_the_reference(fork):
    ops = long_fork_reads(3, 80, 3, fork)
    writes = [{"type": "invoke", "f": "write", "process": 0,
               "value": [["w", k, 1]]} for k in range(3)]
    hist = writes + ops
    ref = ref_long_fork.checker(3).check({}, hist, {})
    assert port_long_fork.checker(3).check({}, hist, {}) == ref
    assert ref["valid?"] is (not fork)

"""The port's verdict service (jepsen_tpu_torch.serve) against the
reference's (jepsen_tpu.serve), on the CPU.

- The wire: the port's frames are the reference's bytes for the same
  payloads, each package's `recv_frame` reads the other's frames, and
  a bad magic, a torn body, an oversized length or a junk body raise
  the same `ProtocolError` message in both.
- The scheduler seam: `fold_cost`, `plan_fold` and `Admission` make the
  same picks as the reference's over lanes made with numpy from seeds
  (weights, an unaffordable head, a drained lane, the depth cap).
- `FoldDispatcher.verdicts` on `device="cpu"` gives the reference's
  verdict dicts, key order included: append (one history past
  `DENSE_TXN_LIMIT`), wr, the host oracles, and an `Exception` entry
  quarantined at `encode`. A failure `supervisor.must_end_sweep` names
  raises instead of being quarantined (the port's departure).
- In-process daemons over copies of one store, two tenants submitting
  by dir and inline (append and wr): the port daemon's welcome and
  verdict frames and its journal lines are the reference daemon's
  bytes, and each verdict equals the port's `analyze-store`
  results.json for that run. shm submissions (port segments) equal the
  dir ones. Each package's client drives the other's daemon.
- Replay after restart with no dispatch, backpressure with the dispatch
  gated, and the subprocess contracts of `python -m
  jepsen_tpu_torch.cli serve --device cpu`: SIGKILL and resume, SIGTERM
  drain, a kernel launch failure inside a fold (the fold unjournaled,
  exit 255), the default device without CUDA (exit 255, no ready line).

Every test sweeps stores of its own; the reference runs with
`JEPSEN_TPU_AOT_CACHE=0` and a private compile cache. Tolerance: exact.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jepsen_tpu.ingest as ref_ingest
import jepsen_tpu.obs as ref_obs
import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu.trace as ref_trace
from jepsen_tpu import gates as ref_gates
from jepsen_tpu.parallel import folding as ref_folding
from jepsen_tpu.serve import protocol as ref_protocol
from jepsen_tpu.serve import scheduler as ref_scheduler
from jepsen_tpu.serve.client import ServeClient as RefClient
from jepsen_tpu.serve.daemon import VerdictDaemon as RefDaemon
from jepsen_tpu_torch import _build, cli, gates, ingest, obs, parallel, trace
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.devices import DeviceUnavailable
from jepsen_tpu_torch.parallel import folding
from jepsen_tpu_torch.serve import protocol, scheduler
from jepsen_tpu_torch.serve.client import ServeClient, ServeError
from jepsen_tpu_torch.serve.daemon import VerdictDaemon
from jepsen_tpu_torch.store import (Store, VerdictJournal,
                                    tenant_journal_path)

REPO = Path(__file__).resolve().parent.parent

SERVE_GATES = ("JEPSEN_TPU_SERVE_SOCKET", "JEPSEN_TPU_SERVE_PORT",
               "JEPSEN_TPU_SERVE_MAX_QUEUE", "JEPSEN_TPU_SERVE_WEIGHTS",
               "JEPSEN_TPU_SERVE_DRAIN_S", "JEPSEN_TPU_SERVE_RETRY_S",
               "JEPSEN_TPU_FLEET_HEARTBEAT_S", "JEPSEN_TPU_FLEET_FAILOVER_S",
               "JEPSEN_TPU_FLEET_SPILL_DEPTH")


@pytest.fixture
def serve_env(tmp_path, monkeypatch):
    """The reference's standing conditions (no shared AOT cache), no
    inherited serve/metrics/health settings, and both packages' tracers
    and flight recorders restored afterwards (a daemon's start() makes
    a fresh tracer)."""
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path / "aot"))
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_INTERVAL_S", "0")
    for var in ("JEPSEN_TPU_METRICS_PORT", "JEPSEN_TPU_SERVE_SOCKET",
                "JEPSEN_TPU_SERVE_PORT", "JEPSEN_TPU_SERVE_WEIGHTS",
                "JEPSEN_TPU_SERVE_MAX_QUEUE", "JEPSEN_TPU_BACKEND",
                "JEPSEN_TPU_STRICT", "JEPSEN_TPU_FAULT_INJECT",
                "JEPSEN_TPU_KERNEL_STATS", "JEPSEN_TPU_PLANNER",
                "JEPSEN_TPU_MESH"):
        monkeypatch.delenv(var, raising=False)
    prev, rprev = trace.get_current(), ref_trace.get_current()
    yield
    trace.set_current(prev)
    ref_trace.set_current(rprev)
    obs.reset_events()
    ref_obs.reset_events()


def make_store(root: Path, b: int = 4, t: int = 96, k: int = 8,
               bad_every: int = 2, wr: int = 0) -> Path:
    """A two-level store: `b` list-append runs under synth/ (every
    `bad_every`-th with G1c) and `wr` rw-register runs under wr/ (every
    second with a write-skew pair)."""
    store = root / "pristine"
    synth.write_synth_run_store(store, B=b, T=t, K=k, bad_every=bad_every)
    if wr:
        synth.write_wr_run_store(store, B=wr, T=t, K=k, bad_every=2)
    return store


def copy_of(store: Path, name: str) -> Path:
    dst = store.parent / name
    shutil.copytree(store, dst)
    return dst


def runs(store: Path, kind: str = "synth") -> list[Path]:
    return sorted(p for p in (store / kind).iterdir() if p.is_dir())


def ops_of(run_dir: Path) -> list[dict]:
    return [json.loads(ln) for ln in
            (run_dir / "history.jsonl").read_text().splitlines() if ln]


def canon(v) -> str:
    return json.dumps(v)


def journal_lines(store: Path, tenant: str) -> list[str]:
    p = tenant_journal_path(store, tenant)
    return sorted(ln for ln in p.read_text().splitlines() if ln.strip()) \
        if p.exists() else []


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

PAYLOADS = [
    {"op": "hello", "tenant": "t"},
    {"op": "hello", "tenant": "fleet-ü", "weight": 2.5},
    {"op": "check", "id": "run-1", "checker": "append",
     "history": [{"type": "ok", "f": "txn", "value": [["append", 1, 2]],
                  "process": 0, "time": 7}]},
    {"op": "verdict", "id": "x", "checker": "wr",
     "result": {"valid?": False, "anomaly-types": ["G2-item"],
                "anomalies": {"G2-item": True}}, "replay": True},
    {"op": "retry-after", "id": "x", "delay_s": 0.2, "queue_depth": 3,
     "draining": True},
    {"op": "bye"},
    {},
]


def frame_bytes(send, payload: dict) -> bytes:
    a, b = socket.socketpair()
    try:
        send(a, payload)
        a.close()
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        b.close()


@pytest.mark.parametrize("payload", PAYLOADS,
                         ids=[p.get("op", "empty") for p in PAYLOADS])
def test_frames_are_the_reference_bytes(payload):
    mine = frame_bytes(protocol.send_frame, payload)
    assert mine == frame_bytes(ref_protocol.send_frame, payload)
    assert mine[:4] == b"JTSV"
    # each package reads the other's frame
    for send, recv in ((protocol.send_frame, ref_protocol.recv_frame),
                       (ref_protocol.send_frame, protocol.recv_frame)):
        a, b = socket.socketpair()
        try:
            send(a, payload)
            a.close()
            assert recv(b) == payload
            assert recv(b) is None      # clean EOF at a frame boundary
        finally:
            b.close()


BAD = {
    "bad-magic": b"XXXX\x00\x00\x00\x02{}",
    "torn-body": b"JTSV" + (100).to_bytes(4, "big") + b"{half",
    "torn-header": b"JTS",
    "oversized": b"JTSV" + ((64 << 20) + 1).to_bytes(4, "big"),
    "junk-body": b"JTSV" + (5).to_bytes(4, "big") + b"{nope",
    "not-an-object": b"JTSV" + (3).to_bytes(4, "big") + b"[1]",
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_frames_raise_like_the_reference(name):
    msgs = []
    for mod in (protocol, ref_protocol):
        a, b = socket.socketpair()
        try:
            a.sendall(BAD[name])
            a.close()
            with pytest.raises(RuntimeError) as ei:
                mod.recv_frame(b)
            assert type(ei.value) is mod.ProtocolError
            msgs.append(str(ei.value))
        finally:
            b.close()
    assert msgs[0] == msgs[1]


def test_oversized_send_is_refused_like_the_reference(monkeypatch):
    monkeypatch.setattr(protocol, "MAX_FRAME", 16)
    monkeypatch.setattr(ref_protocol, "MAX_FRAME", 16)
    for mod in (protocol, ref_protocol):
        a, b = socket.socketpair()
        with pytest.raises(mod.ProtocolError, match="frame too large"):
            mod.send_frame(a, {"op": "check", "id": "x" * 32})
        a.close()
        b.close()


def test_frame_registry_and_limits_equal_the_reference():
    assert protocol.MAGIC == ref_protocol.MAGIC
    assert protocol.MAX_FRAME == ref_protocol.MAX_FRAME
    assert protocol.FRAME_OPS == ref_protocol.FRAME_OPS


@pytest.mark.parametrize("name", SERVE_GATES)
def test_serve_gates_equal_the_reference(name, monkeypatch):
    mine, ref = gates.GATES[name], ref_gates.GATES[name]
    assert (mine.kind, mine.default) == (ref.kind, ref.default)
    for raw in (None, "", "0", "1", "2.5", "bogus", "a=1,b=2"):
        assert mine.parse(raw) == ref.parse(raw), raw


# ---------------------------------------------------------------------------
# the scheduler seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 5000, 32768, 100_000])
def test_fold_cost_equals_the_reference(n):
    assert folding.fold_cost(n) == ref_folding.fold_cost(n)
    assert folding.DEFAULT_FOLD_CELLS == ref_folding.DEFAULT_FOLD_CELLS
    assert folding._MAX_ROUNDS == ref_folding._MAX_ROUNDS


class _Item:
    def __init__(self, rid: str, cost: int):
        self.rid = rid
        self.cost = cost


def lanes_from_seed(mod, seed: int) -> list:
    """Lanes of one package from a numpy seed: 1-4 tenants with random
    weights and queues of random history sizes; seed 3 gives one lane a
    head past the whole budget, seed 4 an empty lane."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(int(rng.integers(1, 5))):
        ln = mod.Lane(f"t{t}", float(rng.choice([0.0, 0.5, 1.0, 2.0, 3.0])))
        for i in range(int(rng.integers(0, 40))):
            n = int(rng.integers(1, 6000))
            ln.queue.append(_Item(f"t{t}/{i}", folding.fold_cost(n)))
        out.append(ln)
    if seed == 3:
        out[0].queue.appendleft(_Item("monster", folding.fold_cost(80_000)))
    if seed == 4:
        out.append(mod.Lane("drained", 5.0))
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("budget", [1 << 22, 1 << 27])
def test_plan_fold_picks_equal_the_reference(seed, budget):
    mine, ref = lanes_from_seed(folding, seed), lanes_from_seed(
        ref_folding, seed)
    for _ in range(12):    # successive folds: deficits carry over
        got = folding.plan_fold(mine, budget_cells=budget, max_histories=16)
        want = ref_folding.plan_fold(ref, budget_cells=budget,
                                     max_histories=16)
        assert [(ln.name, it.rid) for ln, it in got] \
            == [(ln.name, it.rid) for ln, it in want]
        assert [(ln.deficit, len(ln.queue)) for ln in mine] \
            == [(ln.deficit, len(ln.queue)) for ln in ref]
    assert folding.plan_fold([folding.Lane("e")]) == []


def test_plan_fold_unaffordable_head_goes_alone():
    for mod in (folding, ref_folding):
        ln = mod.Lane("t", 1.0)
        big = _Item("big", folding.fold_cost(100_000))
        ln.queue.extend([big, _Item("small", folding.fold_cost(1))])
        picked = mod.plan_fold([ln], budget_cells=folding.fold_cost(1))
        assert [it for _ln, it in picked] == [big]


@pytest.mark.parametrize("spec", ["", "a=3,b=1", " a = 2 ,junk,c=0,d=-1,e=x",
                                  "a=1.5,a=2"])
def test_parse_weights_equals_the_reference(spec):
    assert scheduler.parse_weights(spec) == ref_scheduler.parse_weights(spec)


def admission_trace(mod, seed: int) -> list:
    """One package's Admission driven by a numpy seed: tenants admit
    append and wr requests (t0 set explicitly, so the oldest head is
    the same in both), some refused by the depth cap; folds are drawn
    until the queues drain. Returns everything observable."""
    rng = np.random.default_rng(seed)
    adm = mod.Admission(weights={"t0": 3.0}, max_queue=6)
    seen = [adm.register("t0", 0.5), adm.register("t1", 2.0),
            adm.register("t2")]
    t = 0.0
    for i in range(40):
        tenant = f"t{int(rng.integers(0, 3))}"
        checker = "wr" if rng.random() < 0.3 else "append"
        req = mod.Request(tenant, f"r{i}", checker, enc=None,
                          cost=folding.fold_cost(int(rng.integers(1, 4000))))
        t += 1.0
        req.t0 = t
        seen.append(adm.admit(req))
        if rng.random() < 0.2:
            checker, picked = adm.next_fold(1 << 24, max_histories=5)
            seen.append((checker, [r.rid for r in picked]))
    seen += [adm.pending(), adm.retry_after_s(), adm.depth("t1"),
             adm.tenants_snapshot()]
    while True:
        checker, picked = adm.next_fold(1 << 24, max_histories=5)
        seen.append((checker, [r.rid for r in picked]))
        if not picked:
            break
    adm.close()
    seen.append(adm.admit(mod.Request("t0", "late", "append", None, 1)))
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_admission_folds_equal_the_reference(seed):
    got = admission_trace(scheduler, seed)
    assert got == admission_trace(ref_scheduler, seed)
    assert False in got            # the depth cap refused something
    assert got[-1] is False        # closed admission refuses


# ---------------------------------------------------------------------------
# FoldDispatcher
# ---------------------------------------------------------------------------

def encodings(dirs, checker, mod) -> list:
    return [mod.encode_run_dir(d, checker) for d in dirs]


def assert_same_verdicts(got: list, want: list) -> None:
    assert [canon(g) for g in got] == [canon(w) for w in want]


def test_fold_dispatcher_append_equals_the_reference(tmp_path, serve_env,
                                                     monkeypatch):
    """A fold of short histories, one past DENSE_TXN_LIMIT (lowered in
    both packages, so it rides SCC condensation) and a failed encode."""
    store = make_store(tmp_path, b=4, t=60, bad_every=2)
    synth.write_synth_run_store(store, B=2, T=140, K=8, bad_every=2,
                                name="longer")
    dirs = runs(store) + runs(store, "longer")
    for mod in (parallel, ref_parallel):
        monkeypatch.setattr(mod, "DENSE_TXN_LIMIT", 100)
    bad = ValueError("no history in nowhere")
    mine = encodings(dirs, "append", ingest) + [bad]
    ref = encodings(dirs, "append", ref_ingest) + [bad]
    got = folding.FoldDispatcher("cpu").verdicts(mine, "append")
    want = ref_folding.FoldDispatcher().verdicts(ref, "append")
    assert_same_verdicts(got, want)
    assert got[-1]["quarantined"] == "encode"
    assert [g["valid?"] for g in got[:-1]] == [True, False] * 3


def test_fold_dispatcher_wr_and_host_oracles_equal_the_reference(
        tmp_path, serve_env, monkeypatch):
    store = make_store(tmp_path, b=2, t=60, wr=4)
    wr_dirs, ap_dirs = runs(store, "wr"), runs(store)
    want_wr = ref_folding.FoldDispatcher().verdicts(
        encodings(wr_dirs, "wr", ref_ingest), "wr")
    got_wr = folding.FoldDispatcher("cpu").verdicts(
        encodings(wr_dirs, "wr", ingest), "wr")
    assert_same_verdicts(got_wr, want_wr)
    assert [g["valid?"] for g in got_wr] == [True, False] * 2
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "cpu")
    for checker, dirs in (("append", ap_dirs), ("wr", wr_dirs)):
        got = folding.FoldDispatcher(None).verdicts(
            encodings(dirs, checker, ingest), checker)
        want = ref_folding.FoldDispatcher().verdicts(
            encodings(dirs, checker, ref_ingest), checker)
        assert_same_verdicts(got, want)


FATAL = [_build.KernelLaunchError("closure_square launch failed"),
         _build.KernelBuildError("nvcc failed"),
         DeviceUnavailable("no CUDA device"),
         RuntimeError("CUDA error: an illegal memory access was "
                      "encountered")]


@pytest.mark.parametrize("err", FATAL + [RuntimeError("boom")],
                         ids=["launch", "build", "device", "cuda-error",
                              "other"])
def test_fold_failures_no_quarantine_may_hide_raise(err, tmp_path,
                                                    serve_env, monkeypatch):
    """The departure: what `supervisor.must_end_sweep` names raises out
    of the fold (from its dispatch, or riding the queue as a failed
    encode); any other failure quarantines the fold's histories."""
    store = make_store(tmp_path, b=2, t=40)
    encs = encodings(runs(store), "append", ingest)

    def failing(*a, **kw):
        raise err

    real = parallel.check_bucketed
    monkeypatch.setattr(parallel, "check_bucketed", failing)
    fd = folding.FoldDispatcher("cpu")
    if err in FATAL:
        with pytest.raises(type(err)):
            fd.verdicts(encs, "append")
        monkeypatch.setattr(parallel, "check_bucketed", real)
        with pytest.raises(type(err)):
            folding.FoldDispatcher("cpu").verdicts([encs[0], err], "append")
    else:
        got = fd.verdicts(encs, "append")
        assert [g["quarantined"] for g in got] == ["dispatch"] * 2
        assert got[0]["error"] == "boom"


# ---------------------------------------------------------------------------
# in-process daemons
# ---------------------------------------------------------------------------

class RawTenant:
    """A tenant that keeps every frame it receives as raw bytes."""

    def __init__(self, path, tenant: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(120)
        self.sock.connect(str(path))
        protocol.send_frame(self.sock, {"op": "hello", "tenant": tenant})
        self.welcome = self.read()

    def read(self) -> bytes:
        head = protocol._recv_exact(self.sock, 8)
        n = int.from_bytes(head[4:], "big")
        return head + protocol._recv_exact(self.sock, n)

    def check(self, rid: str, checker: str, **what) -> None:
        protocol.send_frame(self.sock, {"op": "check", "id": rid,
                                        "checker": checker, **what})

    def verdicts(self, n: int) -> dict:
        out = {}
        while len(out) < n:
            raw = self.read()
            f = json.loads(raw[8:])
            assert f["op"] == "verdict", f
            out[(f["id"], f["checker"])] = raw
        return out

    def close(self) -> None:
        protocol.send_frame(self.sock, {"op": "bye"})
        self.sock.close()


def drive_two_tenants(daemon, store: Path) -> dict:
    """Tenant alpha submits the append runs by dir; beta submits them
    inline and the wr runs by dir. Returns welcome and verdict frames."""
    info = daemon.ready_info()["serve"]
    alpha = RawTenant(info["socket"], "alpha")
    beta = RawTenant(info["socket"], "beta")
    for d in runs(store):
        alpha.check(f"dir/{d.name}", "append", dir=str(d))
        beta.check(f"inline/{d.name}", "append", history=ops_of(d))
    for d in runs(store, "wr"):
        beta.check(f"wr/{d.name}", "wr", dir=str(d))
    n = len(runs(store))
    out = {"welcome": [alpha.welcome, beta.welcome],
           "alpha": alpha.verdicts(n),
           "beta": beta.verdicts(n + len(runs(store, "wr")))}
    alpha.close()
    beta.close()
    return out


def sweep_results(store: Path, checker: str) -> dict:
    """The port's analyze-store over a copy: {run name: results.json}."""
    rc = cli.analyze_store(Store(store), checker=checker, device="cpu")
    assert rc in (0, 1)
    kind = "wr" if checker == "wr" else "synth"
    return {d.name: json.loads((d / "results.json").read_text())
            for d in runs(store, kind)}


def test_two_tenant_daemon_bytes_equal_the_reference(tmp_path, serve_env,
                                                     monkeypatch):
    pristine = make_store(tmp_path, b=4, t=96, wr=4)
    mine_store, ref_store = copy_of(pristine, "port"), copy_of(pristine, "ref")
    monkeypatch.setenv("JEPSEN_TPU_METRICS_PORT", "0")
    d = VerdictDaemon(Store(mine_store), device="cpu").start()
    try:
        mine = drive_two_tenants(d, mine_store)
        info = d.ready_info()["serve"]
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{info['metrics_port']}/metrics",
            timeout=30).read().decode()
        section = d._serve_section()["serve"]
        tr = trace.get_current()
        md = tr.metrics_dict()
        spans = [e for e in tr.chrome_events()
                 if e.get("name") == "serve_request"]
    finally:
        assert d.stop() == 0
    monkeypatch.delenv("JEPSEN_TPU_METRICS_PORT")
    rd = RefDaemon(Store(ref_store)).start()
    try:
        ref = drive_two_tenants(rd, ref_store)
    finally:
        assert rd.stop() == 0

    assert mine["welcome"] == ref["welcome"]
    for tenant in ("alpha", "beta"):
        assert mine[tenant] == ref[tenant]           # frame bytes
        assert journal_lines(mine_store, tenant) \
            == journal_lines(ref_store, tenant)       # journal bytes
        assert len(journal_lines(mine_store, tenant)) == len(mine[tenant])

    # each verdict is the port's analyze-store result for that run
    swept = {"append": sweep_results(copy_of(pristine, "sa"), "append"),
             "wr": sweep_results(copy_of(pristine, "sw"), "wr")}
    for tenant in ("alpha", "beta"):
        for (rid, checker), raw in mine[tenant].items():
            res = json.loads(raw[8:])["result"]
            want = swept[checker][rid.split("/")[1]]
            assert canon(res) == canon(want), rid
    assert [json.loads(r[8:])["result"]["valid?"]
            for _k, r in sorted(mine["alpha"].items())] \
        == [True, False, True, False]

    # the telemetry: per-tenant series, the health section, the spans
    assert md["counters"]["serve_verdicts"] == 12
    assert md["counters"]["serve.alpha.verdicts"] == 4
    assert md["counters"]["serve.beta.verdicts"] == 8
    assert md["counters"]["serve_folds"] >= 2    # append and wr never share
    assert "serve_latency_ms" in md["histograms"]
    assert "jepsen_tpu_serve_alpha_verdicts" in page
    assert "jepsen_tpu_serve_beta_verdicts" in page
    assert set(section["tenants"]) == {"alpha", "beta"}
    assert section["tenants"]["beta"]["verdicts"] == 8
    assert len(spans) == 12


def test_shm_inline_and_dir_submissions_agree(tmp_path, serve_env):
    """Within the port (a descriptor names a port segment): a run's
    verdict is the same bytes by dir, inline and shm, for both
    checkers."""
    pristine = make_store(tmp_path, b=3, t=96, wr=2)
    store = copy_of(pristine, "port")
    encs = copy_of(pristine, "encs")
    d = VerdictDaemon(Store(store), device="cpu").start()
    try:
        with ServeClient(socket_path=d.ready_info()["serve"]["socket"],
                         tenant="t") as c:
            for kind, checker in (("synth", "append"), ("wr", "wr")):
                for x in runs(store, kind):
                    c.check_dir(x, checker=checker,
                                rid=f"dir/{checker}/{x.name}")
                    c.check_history(ops_of(x),
                                    rid=f"inline/{checker}/{x.name}",
                                    checker=checker)
                    c.check_encoded(
                        ingest.encode_run_dir(encs / kind / x.name,
                                              checker),
                        rid=f"shm/{checker}/{x.name}", checker=checker)
            got = c.collect(timeout=300)
    finally:
        assert d.stop() == 0
    assert len(got) == 15
    for rid, res in got.items():
        assert canon(res) == canon(got["dir/" + rid.split("/", 1)[1]]), rid
    assert not [p for p in os.listdir("/dev/shm")
                if p.startswith(f"jttshm_{os.getpid()}_")]


@pytest.mark.parametrize("pair", ["reference-client-port-daemon",
                                  "port-client-reference-daemon"])
def test_each_client_drives_the_other_daemon(pair, tmp_path, serve_env):
    store = make_store(tmp_path, b=2, t=60)
    if pair.startswith("reference"):
        daemon, client = VerdictDaemon(Store(store), device="cpu"), RefClient
    else:
        daemon, client = RefDaemon(Store(store)), ServeClient
    daemon.start()
    try:
        with client(socket_path=daemon.ready_info()["serve"]["socket"],
                    tenant="x", weight=2.0) as c:
            assert c.welcome["weight"] == 2.0
            for x in runs(store):
                c.check_dir(x)
                c.check_history(ops_of(x), rid=f"inline/{x.name}")
            got = c.collect(timeout=300)
            assert len(got) == 4
            for x in runs(store):         # a resend replays
                c.check_dir(x)
            c.collect(timeout=300)
            assert c.replays == 2
    finally:
        assert daemon.stop() == 0
    for x in runs(store):
        assert canon(got[str(x)]) == canon(got[f"inline/{x.name}"])
    assert [got[str(x)]["valid?"] for x in runs(store)] == [True, False]


def test_replay_after_restart_runs_no_fold(tmp_path, serve_env):
    store = make_store(tmp_path, b=4)
    d = VerdictDaemon(Store(store), device="cpu").start()
    with ServeClient(socket_path=d.ready_info()["serve"]["socket"],
                     tenant="t") as c:
        for x in runs(store):
            c.check_dir(x)
        first = c.collect(timeout=300)
    assert d.stop() == 0
    d2 = VerdictDaemon(Store(store), device="cpu").start()
    try:
        with ServeClient(socket_path=d2.ready_info()["serve"]["socket"],
                         tenant="t") as c2:
            assert c2.welcome["journaled"] == 4
            for x in runs(store):
                c2.check_dir(x)
            second = c2.collect(timeout=300)
            assert c2.replays == 4
        assert {k: canon(v) for k, v in first.items()} \
            == {k: canon(v) for k, v in second.items()}
        md = trace.get_current().metrics_dict()
        assert md["counters"]["serve_replays"] == 4
        assert md["counters"].get("serve_folds", 0) == 0
    finally:
        assert d2.stop() == 0


class _GatedDispatcher:
    """The first fold blocks until released, so backpressure is
    deterministic to provoke."""

    def __init__(self, inner):
        self.inner = inner
        self.entered = threading.Event()
        self.release = threading.Event()

    def verdicts(self, encs, checker):
        self.entered.set()
        assert self.release.wait(timeout=120)
        return self.inner.verdicts(encs, checker)


def test_backpressure_with_the_dispatch_gated(tmp_path, serve_env):
    store = make_store(tmp_path, b=1, bad_every=0)
    hist = ops_of(runs(store)[0])
    d = VerdictDaemon(Store(store), max_queue=2, device="cpu").start()
    gate = _GatedDispatcher(d._dispatcher)
    d._dispatcher = gate
    try:
        with ServeClient(socket_path=d.ready_info()["serve"]["socket"],
                         tenant="t") as c:
            c.check_history(hist, rid="h0")
            assert gate.entered.wait(timeout=60)
            for i in range(1, 5):
                c.check_history(hist, rid=f"h{i}")
            t = threading.Thread(
                target=lambda: time.sleep(1.0) or gate.release.set())
            t.start()
            got = c.collect(timeout=300)
            t.join()
        assert len(got) == 5
        assert c.retries >= 1
        md = trace.get_current().metrics_dict()
        assert md["counters"]["serve_backpressure"] >= 1
    finally:
        gate.release.set()
        assert d.stop() == 0


def test_kernel_failure_in_a_fold_ends_the_daemon(tmp_path, serve_env,
                                                  monkeypatch):
    """The departure in process: a KernelLaunchError inside the fold
    leaves it unjournaled and unacked, admission closes, and the
    daemon's exit code is 255."""
    store = make_store(tmp_path, b=2, t=40)

    def failing(*a, **kw):
        raise _build.KernelLaunchError("closure_square: launch failed")

    monkeypatch.setattr(parallel, "check_bucketed", failing)
    d = VerdictDaemon(Store(store), device="cpu").start()
    c = ServeClient(socket_path=d.ready_info()["serve"]["socket"],
                    tenant="t", timeout=60)
    c.connect()
    for x in runs(store):
        c.check_dir(x)
    d._sched_thread.join(timeout=60)
    assert not d._sched_thread.is_alive()
    assert isinstance(d.fatal, _build.KernelLaunchError)
    assert d.run_until_drained() == 255
    with pytest.raises((ServeError, OSError)):
        c.collect(timeout=30)
    c.close()
    assert c.verdicts == {}
    assert journal_lines(store, "t") == []
    kinds = [e.get("event") for e in obs.load_events(store)]
    assert "serve_drain" in kinds and "serve_stop" in kinds


# ---------------------------------------------------------------------------
# subprocess: python -m jepsen_tpu_torch.cli serve
# ---------------------------------------------------------------------------

def daemon_env() -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for k in ("JEPSEN_TPU_METRICS_PORT", "JEPSEN_TPU_SERVE_SOCKET",
              "JEPSEN_TPU_SERVE_PORT", "JEPSEN_TPU_BACKEND"):
        env.pop(k, None)
    return env


def spawn(argv: list, timeout: float = 120.0):
    """Start `argv` and read its stdout up to the serve ready line."""
    proc = subprocess.Popen(argv, cwd=REPO, env=daemon_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            err = proc.stderr.read()
            proc.wait(timeout=30)
            raise RuntimeError("daemon died before ready: " + err[-600:])
        try:
            got = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(got, dict) and "serve" in got:
            return proc, got["serve"]
    proc.kill()
    proc.wait(timeout=30)
    raise RuntimeError("daemon ready-line timeout")


def serve_cmd(store: Path, *extra) -> list:
    return [sys.executable, "-m", "jepsen_tpu_torch.cli", "serve",
            "--store", str(store), "--device", "cpu", *extra]


def reap(proc) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=60)
    for f in (proc.stdout, proc.stderr):
        if f is not None:
            f.close()


def raw_line_count(p: Path) -> int:
    if not p.exists():
        return 0
    return sum(1 for ln in p.read_text().splitlines() if ln.strip())


def test_sigkill_then_resume_replays_the_journal(tmp_path):
    store = make_store(tmp_path, b=6, bad_every=3)
    dirs = runs(store)
    proc, ready = spawn(serve_cmd(store))
    try:
        assert ready["device"] == "cpu"
        with ServeClient(socket_path=ready["socket"], tenant="t") as c:
            for x in dirs[:3]:     # closed loop: exactly 3 journaled
                c.check_dir(x)
                c.collect(timeout=120)
    finally:
        reap(proc)
    jp = tenant_journal_path(store, "t")
    assert len(VerdictJournal.load(jp)) == 3
    with open(jp, "a") as f:       # a crash-torn tail
        f.write('{"dir": "torn-mid-wri')
    proc2, ready2 = spawn(serve_cmd(store))
    try:
        with ServeClient(socket_path=ready2["socket"], tenant="t") as c2:
            assert c2.welcome["journaled"] == 3
            for x in dirs:
                c2.check_dir(x)
            got = c2.collect(timeout=300)
            assert len(got) == 6
            assert c2.replays == 3
        assert set(VerdictJournal.load(jp)) \
            == {(str(x), "append") for x in dirs}
        assert raw_line_count(jp) == 7    # 3 + the sealed torn line + 3
        proc2.send_signal(signal.SIGTERM)
        assert proc2.wait(timeout=120) == 0
    finally:
        reap(proc2)


def test_sigterm_drains_without_loss_or_duplication(tmp_path):
    store = make_store(tmp_path, b=6, bad_every=3)
    dirs = runs(store)
    proc, ready = spawn(serve_cmd(store))
    received: dict = {}
    try:
        with ServeClient(socket_path=ready["socket"], tenant="t") as c:
            for x in dirs:
                c.check_dir(x)
            time.sleep(0.5)
            proc.send_signal(signal.SIGTERM)
            try:
                received = c.collect(timeout=120)
            except Exception:
                received = dict(c.verdicts)
        assert proc.wait(timeout=120) == 0
    finally:
        reap(proc)
    jp = tenant_journal_path(store, "t")
    entries = VerdictJournal.load(jp)
    assert set(entries) <= {(str(x), "append") for x in dirs}
    assert {(k, "append") for k in received} <= set(entries)
    assert raw_line_count(jp) == len(entries)


#: `serve` with closure_square's dispatch failing at launch.
FAILING_SERVE = """\
import runpy, sys
import jepsen_tpu_torch.parallel as p
from jepsen_tpu_torch import _build
def fail(*a, **kw):
    raise _build.KernelLaunchError("closure_square: launch failed")
p.check_bucketed = fail
sys.argv[0] = "jepsen_tpu_torch.cli"
runpy.run_module("jepsen_tpu_torch.cli", run_name="__main__",
                 alter_sys=True)
"""


def test_serve_exits_255_on_a_kernel_failure_in_a_fold(tmp_path):
    store = make_store(tmp_path, b=2, t=40)
    proc, ready = spawn([sys.executable, "-c", FAILING_SERVE,
                         *serve_cmd(store)[3:]])
    try:
        c = ServeClient(socket_path=ready["socket"], tenant="t", timeout=60)
        c.connect()
        c.check_dir(runs(store)[0])
        assert proc.wait(timeout=120) == 255
        with pytest.raises((ServeError, OSError)):
            c.collect(timeout=30)
        c.close()
        err = proc.stderr.read()
    finally:
        reap(proc)
    assert "KernelLaunchError" in err
    assert raw_line_count(tenant_journal_path(store, "t")) == 0
    assert not (store / "serve.sock").exists()


@pytest.mark.parametrize("cmd", ["serve", "fleet"])
def test_default_device_without_cuda_exits_before_ready(cmd, tmp_path):
    """Without a card the default device refuses: exit 255, no ready
    line, no socket, and nothing spawned."""
    store = tmp_path / "s"
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", cmd,
         "--store", str(store)], cwd=REPO,
        env={**daemon_env(), "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 255
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
    assert not store.exists()


def test_serve_web_is_named_and_refused(tmp_path, serve_env, monkeypatch):
    """`serve --web` was refused (254) until `web.py` was ported; it now
    serves the store browser on --host and --port instead of the verdict
    daemon (no daemon's socket), and exits 0 once the server stops."""
    from jepsen_tpu_torch import web
    made = []
    real = web.make_server

    def make(store, host="127.0.0.1", port=8080):
        made.append((str(store.base), host, port))
        srv = real(store, host, 0)
        made.append(srv)
        return srv

    monkeypatch.setattr(web, "make_server", make)
    rc = []
    t = threading.Thread(target=lambda: rc.append(cli.main([
        "serve", "--web", "--store", str(tmp_path), "--host", "127.0.0.1",
        "--port", "8123"])))
    t.start()
    deadline = time.monotonic() + 30
    while len(made) < 2:
        assert time.monotonic() < deadline, "serve --web made no server"
        time.sleep(0.01)
    srv = made[1]
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/", timeout=10) as r:
        status, body = r.status, r.read()
    srv.shutdown()
    t.join(30)
    assert not t.is_alive() and rc == [0]
    assert made[0] == (str(tmp_path), "127.0.0.1", 8123)
    assert status == 200 and b"jepsen-tpu store" in body
    assert not (tmp_path / "serve.sock").exists()

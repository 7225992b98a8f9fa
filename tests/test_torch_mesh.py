"""The port's sharded sweep, `analyze-store --mesh`, against the
reference's, on the CPU.

Both CLIs run in this process (tests/test_torch_stored.py's `sweep`):
the port's `cli.main(argv + ["--device", "cpu"])` and the reference's
`run_cli`, each in turn on a copy of one pristine store at one path
(the printed verdict lines and `sweep_start` hold the store's path).
Shard identity comes from the environment, as on a fleet of hosts:
`JEPSEN_TPU_MESH_SHARDS=2` and `JEPSEN_TPU_MESH_SHARD=<k>`, with
`JEPSEN_TPU_MESH_WAIT_S=0` (the coordinator merges at once) and no
coordinator address. The reference runs with `JEPSEN_TPU_AOT_CACHE=0`,
a private compile cache, one device, one core and buffer donation off.
A shard is cut as in tests/test_torch_stored.py: `VerdictJournal.record`
raises KeyboardInterrupt on its k-th call, in both packages.

The cases are those tests/test_mesh_sweep.py pins: a two-shard fleet
against one unsharded sweep; a cut shard resumed from its own journal;
a lost, a crashed and a stale shard; an empty shard and an empty store;
an index out of range and one without a count; and `JEPSEN_TPU_MESH=1`
without `--mesh`. Then two of the port's own: a coordinator address
whose job cannot be joined (no process count, or nobody answering
within a short join timeout) is refused by name with exit 255 — the
joined route itself is tests/test_torch_multidevice.py's — and a shard
process SIGKILLed mid-sweep resumes its assignment.

Tolerance: exact for exit codes, the printed verdict and mesh summary
lines (as parsed JSON), the shards' journals, every run's results.json,
results.edn and `.sweep-append`, the done markers, the names of the
files at the store root, analytics.jsonl, and the non-time fields of
the `sweep_start`, `sweep_resume`, `shard_done` and `shard_lost`
events. The merged trace.json, report.json, metrics.json and
costdb.jsonl carry clock values, so they are compared by structure: the
same `shard<k>:` process tracks, `per_shard` keys "0" and "1" with each
shard's shares summing to 1 ± 0.01, equal values of the counters both
packages count, and the same set of (kernel, geometry) keys."""

import contextlib
import io
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

import jepsen_tpu.gates as ref_gates
import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu.supervisor as ref_sv
from jepsen_tpu_torch import gates, mesh, supervisor, trace
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.store import shard_of
from test_torch_stored import cut_at, sweep

REPO = Path(__file__).resolve().parent.parent
PACKAGES = ("ref", "port")
SHARDS = 2
#: the pristine store's runs: T=40 txns over K=4 keys, every 3rd with G1c
RUNS = 16
MESH_GATES = ("JEPSEN_TPU_MESH", "JEPSEN_TPU_MESH_SHARD",
              "JEPSEN_TPU_MESH_SHARDS", "JEPSEN_TPU_MESH_WAIT_S")
COORDINATOR = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
               "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
EVENTS = ("sweep_start", "sweep_resume", "shard_done", "shard_lost")
PER_RUN = ("results.json", "results.edn", ".sweep-append")
#: counters of metrics.json that both packages count alike
COUNTERS = ("runs_verdicted", "buckets_dispatched", "quarantined")


@pytest.fixture(scope="module", autouse=True)
def mesh_env(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        import jax
        mp.setenv("JEPSEN_TPU_AOT_CACHE", "0")
        mp.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR",
                  str(tmp_path_factory.mktemp("aot")))
        mp.setenv("JEPSEN_TPU_DONATE_BUFFERS", "0")
        mp.setenv("JEPSEN_TPU_BACKEND", "tpu")
        # `--mesh` exports JEPSEN_TPU_MESH; set here, it is restored
        mp.setenv("JEPSEN_TPU_MESH", "0")
        mp.setenv("JEPSEN_TPU_MESH_SHARDS", str(SHARDS))
        mp.setenv("JEPSEN_TPU_MESH_WAIT_S", "0")
        for g in ("JEPSEN_TPU_MESH_SHARD", "JEPSEN_TPU_STRICT",
                  "JEPSEN_TPU_FAULT_INJECT", "JEPSEN_TPU_COSTDB",
                  "JEPSEN_TPU_KERNEL_STATS", "JEPSEN_TPU_PLANNER",
                  "JEPSEN_TPU_REPORT", "JEPSEN_TPU_TRACE",
                  "JEPSEN_TPU_JAX_PROFILE",
                  "JEPSEN_TPU_HEALTH_INTERVAL_S", "JEPSEN_TPU_METRICS_PORT",
                  *COORDINATOR):
            mp.delenv(g, raising=False)
        mp.setattr(os, "cpu_count", lambda: 1)
        one = ref_parallel.make_mesh(jax.devices()[:1])
        mp.setattr(ref_parallel, "make_mesh", lambda *a, **k: one)
        yield
    trace.reset()


@contextlib.contextmanager
def scoped_env(env: dict):
    """`env` set for the block (a None value unsets), then restored."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run(pkg: str, store: Path, argv: list, cut: int | None = None,
        **env) -> tuple:
    """One `analyze-store` call of `pkg` with `env` set for it; returns
    (exit code, the JSON lines it printed, parsed, its stderr and log
    text). The reference's `--mesh` leaves JEPSEN_TPU_MESH exported;
    it is restored after the call."""
    env = {"JEPSEN_TPU_MESH": os.environ.get("JEPSEN_TPU_MESH"), **env}
    out, err = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(err)
    logging.getLogger().addHandler(handler)
    try:
        with scoped_env(env), cut_at(cut), \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = sweep(pkg, store, argv)
    finally:
        logging.getLogger().removeHandler(handler)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    return rc, lines, err.getvalue()


def shard(k: int, *argv, cut: int | None = None, **env):
    """A step: shard k of the mesh, `--mesh` and `argv`."""
    return lambda pkg, store: run(pkg, store, ["--mesh", *argv], cut=cut,
                                  JEPSEN_TPU_MESH_SHARD=k, **env)


def in_turn(tmp: Path, pristine: Path, steps: list) -> dict:
    """Each package in turn on one path: copy `pristine` in, run
    `steps` (each `step(pkg, store)`), and move the store aside.
    Returns {package: [each step's result]}."""
    work = tmp / "store"
    got = {}
    for pkg in PACKAGES:
        shutil.copytree(pristine, work)
        got[pkg] = [step(pkg, work) for step in steps]
        shutil.move(str(work), tempfile.mkdtemp(dir=tmp))
    return got


def run_keys(store: Path) -> list[str]:
    return sorted(f"synth/{d.name}" for d in (store / "synth").iterdir())


def assignment(keys, k: int, n: int = SHARDS) -> set:
    return {key for key in keys if shard_of(key, n) == k}


def keys_of(lines: list) -> set:
    """The run keys (`<name>/<run>`) of the per-run verdict lines."""
    return {"/".join(Path(e["dir"]).parts[-2:]) for e in lines
            if "dir" in e}


def summary(lines: list) -> dict:
    got = [e for e in lines if e.get("mesh") is True]
    assert len(got) == 1, lines
    return got[0]


def journal(store: Path, k: int) -> list[dict]:
    p = mesh.shard_journal_path(store, k)
    return [json.loads(ln) for ln in p.read_text().splitlines()] \
        if p.exists() else []


def events(store: Path) -> list:
    out = []
    p = store / "events.jsonl"
    for ln in (p.read_text().splitlines() if p.exists() else []):
        e = json.loads(ln)
        if e["event"] in EVENTS:
            out.append({k: v for k, v in e.items()
                        if k not in ("t_mono", "t_wall", "pid")})
    return out


def snapshot(pkg: str, store: Path) -> dict:
    """What the packages must leave alike, exactly (a step)."""
    out = {"root": sorted(os.listdir(store)), "events": events(store)}
    for key in run_keys(store):
        for f in PER_RUN:
            p = store / key / f
            out[f"{key}/{f}"] = p.read_bytes() if p.exists() else None
    for k in range(SHARDS):
        out[f"verdicts-{k}"] = journal(store, k)
        out[f"done-{k}"] = supervisor.load_shard_done(store, k)
    p = store / "analytics.jsonl"
    out["analytics"] = p.read_bytes() if p.exists() else None
    return out


def merged(pkg: str, store: Path) -> dict:
    """The merged telemetry, compared by structure (a step)."""
    tr = json.loads((store / "trace.json").read_text())
    rep = json.loads((store / "report.json").read_text())
    metrics = json.loads((store / "metrics.json").read_text())
    cost = [json.loads(ln) for ln in
            (store / "costdb.jsonl").read_text().splitlines()]
    return {"tracks": sorted(e["args"]["name"] for e in tr["traceEvents"]
                             if e.get("name") == "process_name"),
            "per_shard": sorted(rep["per_shard"]),
            "shares_sum_to_1": all(
                abs(sum(v["shares"].values()) - 1.0) <= 0.01
                for v in rep["per_shard"].values()),
            "counters": {c: metrics["counters"].get(c) for c in COUNTERS},
            "shard_counters": {
                k: {c: m["counters"].get(c) for c in COUNTERS}
                for k, m in metrics["per_shard"].items()},
            "cost": sorted((r["kernel"], json.dumps(r["geometry"],
                                                    sort_keys=True))
                           for r in cost)}


def assert_same(got: dict, steps: slice = slice(None)) -> None:
    ref, port = got["ref"][steps], got["port"][steps]
    assert len(ref) == len(port)
    for i, (r, p) in enumerate(zip(ref, port)):
        if isinstance(r, tuple):       # a CLI call: rc and lines
            assert r[:2] == p[:2], (i, r[2][-2000:], p[2][-2000:])
        elif isinstance(r, dict):
            assert r.keys() == p.keys(), i
            for k in r:
                assert r[k] == p[k], (i, k)
        else:
            assert r == p, i


@pytest.fixture(scope="module")
def pristine(tmp_path_factory) -> Path:
    base = tmp_path_factory.mktemp("mesh") / "pristine"
    synth.write_synth_run_store(base, B=RUNS, T=40, K=4, bad_every=3)
    keys = run_keys(base)
    assert all(assignment(keys, k) for k in range(SHARDS)), \
        "degenerate hash split"
    return base


# -- gates ----------------------------------------------------------------------

@pytest.mark.parametrize("name", MESH_GATES)
def test_mesh_gates_are_the_reference_s(name):
    mine, ref = gates.GATES[name], ref_gates.GATES[name]
    assert (mine.kind, mine.default) == (ref.kind, ref.default)


def test_split_is_the_reference_s(pristine):
    from jepsen_tpu.store import Store as RefStore
    from jepsen_tpu_torch.store import Store
    for k in range(3):
        assert list(Store(pristine).iter_run_dirs(shard=k, n_shards=3)) \
            == list(RefStore(pristine).iter_run_dirs(shard=k, n_shards=3))


def test_shard_trace_merge_and_report_are_the_reference_s(tmp_path):
    """Two shards' exports (the port's tracer, with spans, a device
    window and a counter) merged by both packages: the same events, the
    same per-shard decomposition and the same report.md."""
    import jepsen_tpu.obs.attribution as ref_attr
    import jepsen_tpu.trace as ref_trace
    from jepsen_tpu_torch.obs import attribution
    for k in range(SHARDS):
        tr = trace.Tracer(run=f"analyze-store:append@shard{k}/2",
                          scope="sweep")
        with tr.span("parse"):
            time.sleep(0.002)
        t0 = time.perf_counter()
        time.sleep(0.002 * (k + 1))
        tr.device_complete("dispatch", t0)
        tr.counter("runs_verdicted").inc(3 + k)
        trace.export_shard_trace(tr, tmp_path, k, SHARDS,
                                 tr.chrome_events())
        tr.export_metrics(tmp_path / f"metrics-shard{k}.json")
    evs, per_shard = trace.merge_shard_traces(tmp_path, range(SHARDS))
    assert (evs, per_shard) == ref_trace.merge_shard_traces(
        tmp_path, range(SHARDS))
    names = [e["args"]["name"] for e in evs if e["name"] == "process_name"]
    assert names == [f"shard{k}:analyze-store:append@shard{k}/2"
                     for k in range(SHARDS)]
    assert len({e["pid"] for e in evs}) == SHARDS
    shards = attribution.analyze_shards(per_shard)
    assert shards == ref_attr.analyze_shards(per_shard)
    rep = {**attribution.analyze(evs), "per_shard": shards}
    md = attribution.render_report_md(rep)
    assert md == ref_attr.render_report_md(rep)
    assert "## Per-shard decomposition (mesh sweep)" in md
    import jepsen_tpu.mesh as ref_mesh
    metrics = mesh.merge_shard_metrics(tmp_path, SHARDS)
    assert metrics == ref_mesh.merge_shard_metrics(tmp_path, SHARDS)
    assert metrics["counters"]["runs_verdicted"] == 7
    assert sorted(metrics["per_shard"]) == ["0", "1"]


# -- a whole fleet, then a stale marker ----------------------------------------

@pytest.fixture(scope="module")
def fleet(pristine, tmp_path_factory) -> dict:
    """Shard 1, then shard 0 (the coordinator, `--report`), both with
    the stats gate and the costdb on; then shard 1's journal removed
    and shard 0 resumed against its stale marker. And one unsharded
    port sweep of the same store."""
    tmp = tmp_path_factory.mktemp("fleet")
    gated = {"JEPSEN_TPU_KERNEL_STATS": 1, "JEPSEN_TPU_COSTDB": 1}

    def stale(pkg, store):
        mesh.shard_journal_path(store, 1).unlink()
        return shard(0, "--resume")(pkg, store)

    got = in_turn(tmp, pristine, [
        shard(1, **gated), shard(0, "--report", **gated), snapshot,
        merged, stale])
    whole = tmp / "whole"
    shutil.copytree(pristine, whole)
    rc, lines, err = run("port", whole, [])
    assert rc == 1, err[-2000:]
    got["whole"] = whole
    return got


def test_two_shards_equal_the_reference(fleet):
    assert_same(fleet, slice(0, 3))
    (rc1, lines1, _), (rc0, lines0, _), snap = fleet["port"][:3]
    assert (rc1, rc0) == (1, 1)
    s = summary(lines0)
    assert (s["runs_total"], s["runs_verdicted"], s["unaccounted"]) \
        == (RUNS, RUNS, 0)
    assert s["invalid"] == RUNS // 3 and s["valid?"] is False
    assert s["lost_shards"] == s["crashed_shards"] \
        == s["incomplete_shards"] == []
    assert snap["done-1"] == {"shard": 1, "shards": 2,
                              "checker": "append", "exit_code": 1}
    assert snap["analytics"] is not None
    assert [e["event"] for e in snap["events"]] == \
        ["sweep_start", "sweep_start", "shard_done"]
    assert {"verdicts-0.jsonl", "verdicts-1.jsonl", ".shard-0.done",
            ".shard-1.done", "trace-shard0.json", "trace-shard1.json",
            "metrics-shard0.json", "metrics-shard1.json",
            "costdb-shard0.jsonl", "costdb-shard1.jsonl",
            "analytics-shard0.jsonl", "analytics-shard1.jsonl",
            "trace.json", "metrics.json", "report.json", "costdb.jsonl",
            "analytics.jsonl"} <= set(snap["root"])
    assert "verdicts.jsonl" not in snap["root"]


def test_each_shard_sweeps_its_own_slice(fleet, pristine):
    keys = run_keys(pristine)
    for k, (_rc, lines, _err) in ((1, fleet["port"][0]),
                                  (0, fleet["port"][1])):
        assert keys_of(lines) == assignment(keys, k), k
        assert {e["dir"] for e in fleet["port"][2][f"verdicts-{k}"]} \
            == assignment(keys, k)


def test_two_shards_equal_one_unsharded_sweep(fleet, pristine):
    snap, whole = fleet["port"][2], fleet["whole"]
    for key in run_keys(pristine):
        for f in ("results.json", "results.edn"):
            assert snap[f"{key}/{f}"] == (whole / key / f).read_bytes(), \
                (key, f)
    # the journals together are the unsharded journal, line for line
    lines = {e["dir"]: e for e in
             map(json.loads, (whole / "verdicts.jsonl").read_text()
                 .splitlines())}
    sharded = {e["dir"]: e for k in range(SHARDS)
               for e in snap[f"verdicts-{k}"]}
    assert sharded == lines


def test_merged_telemetry_has_the_reference_s_structure(fleet):
    ref, port = fleet["ref"][3], fleet["port"][3]
    assert port == ref
    assert any(t.startswith("shard0:") for t in port["tracks"])
    assert any(t.startswith("shard1:") for t in port["tracks"])
    assert port["per_shard"] == ["0", "1"] and port["shares_sum_to_1"]
    assert port["counters"]["runs_verdicted"] == RUNS
    assert port["cost"]


def test_stale_marker_reads_incomplete(fleet):
    assert_same(fleet, slice(4, 5))
    rc, lines, _ = fleet["port"][4]
    assert rc == 2
    s = summary(lines)
    assert s["incomplete_shards"] == [1] and s["unaccounted"] > 0
    assert s["lost_shards"] == [] and s["valid?"] is False


# -- lost, cut and resumed -----------------------------------------------------

CUT = 3


@pytest.fixture(scope="module")
def cut_fleet(pristine, tmp_path_factory) -> dict:
    """Shard 0 with shard 1 never run (lost); shard 1 cut at its CUT-th
    journal line; every per-run marker stripped (journal-only
    evidence); shard 1 resumed; shard 0 resumed with `--report`."""
    tmp = tmp_path_factory.mktemp("cut")

    def strip(pkg, store):
        before = {k: journal(store, k) for k in range(SHARDS)}
        for key in run_keys(store):
            for f in ("results.json", ".sweep-append"):
                (store / key / f).unlink(missing_ok=True)
        return before

    return in_turn(tmp, pristine, [
        shard(0), shard(1, cut=CUT), strip, shard(1, "--resume"),
        shard(0, "--resume", "--report"), snapshot])


def test_cut_fleet_equals_the_reference(cut_fleet):
    assert_same(cut_fleet)


def test_lost_shard_floors_the_exit_at_2(cut_fleet):
    rc, lines, _ = cut_fleet["port"][0]
    assert rc == 2
    s = summary(lines)
    assert s["lost_shards"] == [1] and s["valid?"] is False
    assert {"event": "shard_lost", "shard": 1, "shards": 2} \
        in cut_fleet["port"][5]["events"]


def test_cut_shard_resumes_from_its_own_journal(cut_fleet, pristine):
    keys = run_keys(pristine)
    (rc_cut, _l, _e), before, (rc, lines, _) = cut_fleet["port"][1:4]
    assert rc_cut == 255
    # the cut run's results landed, its journal line did not
    journaled = {e["dir"] for e in before[1]}
    assert len(journaled) == CUT - 1
    assert rc in (0, 1)
    assert keys_of(lines) == assignment(keys, 1) - journaled
    # every run of the shard journaled once
    got = [e["dir"] for e in cut_fleet["port"][5]["verdicts-1"]]
    assert sorted(got) == sorted(assignment(keys, 1))


def test_coordinator_resume_merges_a_complete_fleet(cut_fleet):
    rc, lines, err = cut_fleet["port"][4]
    assert rc == 1
    assert "nothing to resume" in err
    s = summary(lines)
    assert (s["runs_verdicted"], s["unaccounted"], s["lost_shards"]) \
        == (RUNS, 0, [])
    # the resume checked nothing: it kept its earlier shard trace
    assert "keeping" in err


# -- crashed, empty, out of range ----------------------------------------------

def test_crashed_marker_floors_the_exit_at_2(pristine, tmp_path):
    def crashed(pkg, store):
        sv = ref_sv if pkg == "ref" else supervisor
        sv.mark_shard_done(store, 1, {"shard": 1, "shards": 2,
                                      "checker": "append",
                                      "exit_code": "crashed"})
    got = in_turn(tmp_path, pristine, [crashed, shard(0), snapshot])
    assert_same(got)
    rc, lines, _ = got["port"][1]
    assert rc == 2
    s = summary(lines)
    assert s["crashed_shards"] == [1] and s["unaccounted"] > 0
    assert s["valid?"] is False


def test_empty_shard_and_empty_store(tmp_path):
    one = tmp_path / "one"
    synth.write_synth_run_store(one, B=1, T=40, K=4, bad_every=0)
    key = run_keys(one)[0]
    empty = max({1, 2, 3} - {shard_of(key, 4)})
    got = in_turn(tmp_path, one, [
        shard(empty, JEPSEN_TPU_MESH_SHARDS=4),
        lambda pkg, store: shard(1)(pkg, store.parent / "nostore")])
    for pkg in PACKAGES:
        (rc, lines, err), (rc_none, _, _) = got[pkg]
        assert (rc, lines, rc_none) == (0, [], 254), pkg
        assert "no runs assigned" in err


@pytest.mark.parametrize("env, says", [
    ({"JEPSEN_TPU_MESH_SHARD": 2}, "out of range"),
    ({"JEPSEN_TPU_MESH_SHARD": 1, "JEPSEN_TPU_MESH_SHARDS": None},
     "no shard count"),
], ids=["out-of-range", "no-count"])
def test_bad_shard_identity_is_refused(env, says, pristine, tmp_path):
    got = in_turn(tmp_path, pristine, [
        lambda pkg, store: run(pkg, store, ["--mesh"], **env),
        lambda pkg, store: sorted(os.listdir(store))])
    for pkg in PACKAGES:
        (rc, lines, err), root = got[pkg]
        assert (rc, lines) == (255, []), pkg
        assert says in err, pkg
        assert root == sorted(os.listdir(pristine)), pkg


# -- the repair: JEPSEN_TPU_MESH alone shards the sweep -------------------------

def test_mesh_gate_alone_shards_the_sweep(pristine, tmp_path):
    """`JEPSEN_TPU_MESH=1` without `--mesh` is a mesh sweep in both
    packages: one shard's runs and the sharded file names."""
    got = in_turn(tmp_path, pristine, [
        lambda pkg, store: run(pkg, store, [], JEPSEN_TPU_MESH=1,
                               JEPSEN_TPU_MESH_SHARD=1),
        snapshot])
    assert_same(got)
    (rc, lines, _), snap = got["port"]
    assert rc == 1
    assert {e["dir"] for e in snap["verdicts-1"]} == \
        assignment(run_keys(pristine), 1)
    assert len(lines) == len(snap["verdicts-1"]) < RUNS
    assert {"verdicts-1.jsonl", "trace-shard1.json", "metrics-shard1.json",
            ".shard-1.done"} <= set(snap["root"])
    assert not {"verdicts.jsonl", "trace.json", "metrics.json"} \
        & set(snap["root"])


# -- the port's own -------------------------------------------------------------

def _unanswered() -> str:
    """127.0.0.1 at a port nothing listens on."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


@pytest.mark.parametrize("job", ["no-count", "no-answer"])
@pytest.mark.parametrize("var", ["JAX_COORDINATOR_ADDRESS",
                                 "COORDINATOR_ADDRESS"])
def test_coordinator_address_without_count_is_refused(var, job, pristine,
                                                      tmp_path,
                                                      monkeypatch):
    """A coordinator address with no shard count joins its job (the
    reference's route). A job that cannot be joined — no process count,
    or a rendezvous nobody answers within the (shortened) join timeout
    — is refused by name, exit 255, writing nothing."""
    from jepsen_tpu_torch import parallel
    monkeypatch.setattr(parallel, "JOIN_TIMEOUT_S", 2.0)
    store = tmp_path / "store"
    shutil.copytree(pristine, store)
    before = sorted(p.relative_to(store) for p in store.rglob("*"))
    env = {var: _unanswered(), "JEPSEN_TPU_MESH_SHARDS": None,
           **({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}
              if job == "no-answer" else {})}
    with pytest.raises(RuntimeError, match="mesh shard identity "
                       "unresolvable.*JEPSEN_TPU_MESH_SHARDS"):
        with scoped_env(env):
            mesh.resolve_shard()
    rc, lines, err = run("port", store, ["--mesh"], **env)
    assert (rc, lines) == (255, [])
    assert "coordinator address" in err and "jax.distributed" in err
    assert sorted(p.relative_to(store) for p in store.rglob("*")) == before


def group_alive(pgid: int) -> list[int]:
    """The live (not zombie) processes of process group `pgid`."""
    out = []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            stat = Path(f"/proc/{p}/stat").read_text()
        except OSError:
            continue
        state, _ppid, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        if int(pgrp) == pgid and state != "Z":
            out.append(int(p))
    return out


def kill_group(proc: subprocess.Popen) -> None:
    """SIGKILL `proc`'s process group and wait until none of it is left."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait(timeout=60)
    deadline = time.monotonic() + 30
    while group_alive(proc.pid):
        assert time.monotonic() < deadline, "the shard's group outlived it"
        time.sleep(0.05)


def journaled_keys(path: Path, unique: bool = True):
    """The runs of a journal's whole lines (a torn tail is skipped)."""
    keys = []
    for ln in path.read_text().splitlines():
        with contextlib.suppress(json.JSONDecodeError):
            keys.append(json.loads(ln)["dir"])
    return set(keys) if unique else keys


def test_killed_shard_process_resumes_its_assignment(tmp_path):
    """`python -m jepsen_tpu_torch.cli analyze-store --mesh --device cpu`
    as shard 1, SIGKILLed once its journal grows; shard 1 `--resume`
    then verdicts the rest of its assignment, each run journaled once."""
    store = tmp_path / "store"
    synth.write_synth_run_store(store, B=96, T=30, K=4, bad_every=0)
    mine = assignment(run_keys(store), 1)
    env = {**os.environ, "JEPSEN_TPU_MESH_SHARD": "1",
           "JEPSEN_TPU_ENCODE_CACHE": "0"}
    argv = [sys.executable, "-m", "jepsen_tpu_torch.cli", "analyze-store",
            "--store", str(store), "--mesh", "--device", "cpu"]
    jp = mesh.shard_journal_path(store, 1)
    # its own process group: the kill takes the shard's ingest workers
    # and resource tracker with it, as a host's death would
    proc = subprocess.Popen(argv, cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL,
                            start_new_session=True)
    try:
        deadline = time.monotonic() + 120
        while not (jp.exists() and jp.stat().st_size) \
                and proc.poll() is None:
            assert time.monotonic() < deadline, "shard 1 journaled nothing"
            time.sleep(0.001)
    finally:
        kill_group(proc)
    assert not supervisor.shard_done_path(store, 1).exists(), \
        "the kill came after the sweep ended"
    cut = journaled_keys(jp)
    assert cut and cut < mine
    # journal-only evidence: a SIGKILL may land between a run's marker
    # and its journal line
    for key in mine:
        for f in ("results.json", ".sweep-append"):
            (store / key / f).unlink(missing_ok=True)
    res = subprocess.run(argv + ["--resume"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    resumed = [json.loads(ln) for ln in res.stdout.splitlines()
               if ln.startswith("{")]
    assert keys_of(resumed) == mine - cut
    assert sorted(journaled_keys(jp, unique=False)) == sorted(mine)
    assert supervisor.load_shard_done(store, 1)["exit_code"] == 0

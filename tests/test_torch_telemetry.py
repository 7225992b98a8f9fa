"""The port's sweep telemetry (jepsen_tpu_torch.trace, obs.events,
obs.search, obs.attribution, the CLI's sweep tracer) against the
reference's, on the CPU.

Unit cases copied from tests/test_trace.py and tests/test_obs.py and
pointed at the port: the golden Chrome-event shape, device lanes,
thread tracks, the JEPSEN_TPU_TRACE=0 null tracer, phase parity with
the `phases` dict, idempotent collection, atomic export, the typed
event log and its rotation. The report's arithmetic (`analyze`, the
markdown) and the search section run on the same inputs in both
packages.

Then whole sweeps: each store is swept by both CLIs on one path in turn
(tests/test_torch_stored.py's `in_turn`, so paths inside events and
records agree), with `JEPSEN_TPU_KERNEL_STATS=1` and `--report`, the
reference with `JEPSEN_TPU_AOT_CACHE=0`, a private compile cache, a
one-core `os.cpu_count` (serial ingest) and buffer donation off
(`JEPSEN_TPU_DONATE_BUFFERS=0`: the port has no donation). The first
cases run with the encode-sidecar cache and the native encoder off
(`JEPSEN_TPU_ENCODE_CACHE=0`, `JEPSEN_TPU_NATIVE_INGEST=0`), the
`native-*` cases with both at their defaults, cold (no sidecars) and
warm (each package's own sidecars, from a first sweep whose telemetry
and verdicts are cleared). The `pooled-*` cases give both a two-core
`os.cpu_count`, so each ingests through its process pool: the pool's
counters (`shm_bytes`, `worker_spans`, `shm_stale_reclaimed`), its
`worker.*` histograms and the workers' own pid tracks compare too,
with pids in track names and the lanes of concurrent parse windows
normalised, and the `reorder_depth` gauge (how far results arrived out
of order) compared by presence.

Tolerance: exact. analytics.jsonl byte-identical; counters and gauges
equal; event kinds and non-time fields equal in order; the trace's
(name, category, phase) set and track names equal; the report's keys
and stage names equal; verdict files byte-identical."""

import json
import os
import re
import time

import pytest
import torch

import jepsen_tpu.gates as ref_gates
import jepsen_tpu.obs.attribution as ref_attr
import jepsen_tpu.obs.search as ref_search
import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu.supervisor as ref_sv
from jepsen_tpu_torch import cli, gates, obs, parallel, trace
from jepsen_tpu_torch import parallel as port_parallel
from jepsen_tpu_torch import supervisor as sv
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.elle.encode import encode_history
from jepsen_tpu_torch.obs import attribution, search
from jepsen_tpu_torch.store import Store, load_analytics
from test_torch_cli import reference_env  # noqa: F401
from test_torch_register import mixed_store as register_store
from test_torch_stored import assert_same, in_turn

CPU = torch.device("cpu")

NEW_GATES = ("JEPSEN_TPU_TRACE", "JEPSEN_TPU_TRACE_MAX_EVENTS",
             "JEPSEN_TPU_REPORT", "JEPSEN_TPU_JAX_PROFILE",
             "JEPSEN_TPU_EVENTS_MAX_BYTES", "JEPSEN_TPU_KERNEL_STATS",
             "JEPSEN_TPU_KERNEL_STATS_SAMPLE")
RAWS = [None, "", "0", "1", "yes", "false", " 2.5 ", "abc", "-1", "7",
        "0.0", "  "]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """A clean tracer and recorder, and the telemetry gates unset."""
    for name in NEW_GATES + ("JEPSEN_TPU_FAULT_INJECT",):
        monkeypatch.delenv(name, raising=False)
    trace.reset()
    obs.reset_events()
    search.reset()
    yield
    trace.reset()
    obs.reset_events()
    search.reset()


@pytest.mark.parametrize("name", NEW_GATES)
def test_gate_parse_rules_match_reference(name):
    mine, ref = gates.GATES[name], ref_gates.GATES[name]
    assert (mine.kind, mine.default) == (ref.kind, ref.default)
    for raw in RAWS:
        assert mine.parse(raw) == ref.parse(raw), raw


# -- the tracer (tests/test_trace.py's cases) ------------------------------

def _validate_chrome(obj):
    """The golden shape: timed events are complete ("X") events with the
    required keys, sorted by non-negative ts."""
    evs = obj["traceEvents"]
    assert isinstance(evs, list) and evs
    last_ts = None
    for e in evs:
        assert e["ph"] in ("X", "M"), e
        assert isinstance(e["name"], str) and e["name"]
        assert "pid" in e
        if e["ph"] == "M":
            assert "name" in e["args"]
            continue
        assert "tid" in e
        assert e["ts"] >= 0 and e["dur"] >= 0, e
        if last_ts is not None:
            assert e["ts"] >= last_ts, "events must be ts-sorted"
        last_ts = e["ts"]


def test_trace_export_golden_shape(tmp_path):
    tr = trace.fresh_run("unit")
    with tr.span("outer", k=1):
        with tr.span("inner"):
            pass
    t0 = time.perf_counter()
    tr.phase("pack", t0)
    tr.device_complete("bucket", t0, histories=2)
    tr.counter("buckets_dispatched").inc(3)
    tr.gauge("inflight_depth").set(2)
    obj = json.loads(tr.export(tmp_path / "trace.json").read_text())
    _validate_chrome(obj)
    assert {"outer", "inner", "pack", "bucket"} <= \
        {e["name"] for e in obj["traceEvents"]}
    dev = [e for e in obj["traceEvents"]
           if e.get("tid") == trace.DEVICE_TID and e["ph"] == "X"]
    assert dev and dev[0]["cat"] == "device"
    assert "device" in {e["args"]["name"] for e in obj["traceEvents"]
                        if e["ph"] == "M"}
    m = json.loads(tr.export_metrics(tmp_path / "metrics.json").read_text())
    assert m["counters"]["buckets_dispatched"] == 3
    assert m["gauges"]["inflight_depth"] == 2
    assert m["histograms"]["phase.pack"]["count"] == 1


def test_overlapping_device_windows_spill_to_lanes(tmp_path):
    tr = trace.fresh_run("lanes")
    t0 = time.perf_counter()
    tr.device_complete("bucket", t0, t0 + 0.010)
    tr.device_complete("bucket", t0 + 0.002, t0 + 0.008)  # overlaps
    tr.device_complete("bucket", t0 + 0.020, t0 + 0.021)  # lane 0 free
    obj = json.loads(tr.export(tmp_path / "t.json").read_text())
    by_tid: dict = {}
    for e in obj["traceEvents"]:
        if e["ph"] == "X":
            by_tid.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    assert len(by_tid) == 2
    for spans in by_tid.values():
        spans.sort()
        for (_, e1), (s2, _) in zip(spans, spans[1:]):
            assert s2 >= e1, "partial overlap within one tid"
    assert {"device", "device-2"} <= {
        e["args"]["name"] for e in obj["traceEvents"]
        if e["ph"] == "M" and e["name"] == "thread_name"}


def test_nested_spans_and_thread_tracks(tmp_path):
    import threading

    tr = trace.fresh_run("threads")

    def work():
        with tr.span("worker-span"):
            time.sleep(0.001)

    t = threading.Thread(target=work, name="span-worker")
    with tr.span("main-span"):
        t.start()
        t.join()
    obj = json.loads(tr.export(tmp_path / "t.json").read_text())
    _validate_chrome(obj)
    assert len({e["tid"] for e in obj["traceEvents"] if e["ph"] == "X"}) == 2
    assert "span-worker" in {e["args"]["name"] for e in obj["traceEvents"]
                             if e["ph"] == "M" and e["name"] == "thread_name"}


def test_disabled_tracer_no_file_and_cheap(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_TRACE", "0")
    trace.reset()
    tr = trace.get_current()
    assert isinstance(tr, trace.NullTracer)
    assert tr.export(tmp_path / "t.json") is None
    assert not (tmp_path / "t.json").exists()
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("hot"):
            pass
    dt = time.perf_counter() - t0
    assert dt / n < 10e-6, f"{dt / n * 1e6:.2f}µs per disabled span"
    assert trace.merge_traces(tr) == []
    assert tr.phase("pack", time.perf_counter()) >= 0
    assert tr.phase_totals() == {}


def make_encs(n=3, T=60):
    return [encode_history(synth.synth_append_history(T=T + 30 * i, K=6,
                                                      seed=i))
            for i in range(n)]


def test_sweep_phases_match_tracer_and_metrics():
    """The `phases` dict and the tracer's totals are the same numbers,
    and a sweep leaves the dispatch metrics and a device window."""
    tr = trace.fresh_run("sweep")
    phases: dict = {}
    out = parallel.check_bucketed_async(make_encs(), CPU,
                                        phases=phases).result()
    assert all(o == {} for o in out)
    totals = tr.phase_totals()
    for k in ("pack", "h2d", "dispatch", "collect"):
        assert totals[k] == pytest.approx(phases[k], rel=0.01)
    md = tr.metrics_dict()
    assert md["counters"]["buckets_dispatched"] == \
        md["counters"]["buckets_resolved"] >= 1
    assert md["gauges"]["inflight_depth"] == 0
    assert md["counters"]["pad_waste_cells"] >= 0
    assert any(e.get("cat") == "device" for e in tr.chrome_events())


def test_pending_verdicts_result_idempotent():
    trace.fresh_run("idem")
    phases: dict = {}
    pv = parallel.check_bucketed_async(make_encs(4), CPU, phases=phases)
    first = pv.result()
    collect1 = phases["collect"]
    assert pv.result() is first and None not in first
    assert phases["collect"] == collect1


def test_trace_export_atomic_no_tmp_droppings(tmp_path):
    tr = trace.Tracer(run="atomic")
    with tr.span("s"):
        pass
    for _ in range(2):
        p = tr.export(tmp_path / "trace.json")
        m = tr.export_metrics(tmp_path / "metrics.json")
    assert json.loads(p.read_text())["traceEvents"]
    assert "counters" in json.loads(m.read_text())
    assert not list(tmp_path.glob(".trace.json.*"))
    assert not list(tmp_path.glob(".metrics.json.*"))


def test_trace_export_failure_leaves_previous_artifact(tmp_path,
                                                       monkeypatch):
    tr = trace.Tracer(run="crash")
    p = tr.export_metrics(tmp_path / "metrics.json")
    before = p.read_text()

    def boom(src, dst):
        raise OSError("simulated crash at rename")

    real = os.replace
    monkeypatch.setattr(os, "replace", boom)
    tr.counter("quarantined").inc()
    with pytest.raises(OSError):
        tr.export_metrics(tmp_path / "metrics.json")
    monkeypatch.setattr(os, "replace", real)
    assert p.read_text() == before
    assert not list(tmp_path.glob(".metrics.json.*"))


def test_profile_session_is_a_no_op_when_off_and_traces_when_on(
        tmp_path, monkeypatch):
    with trace.profile_session(tmp_path / "off") as ps:
        torch.ones(4).sum()
    assert ps.path is None and not (tmp_path / "off").exists()
    monkeypatch.setenv("JEPSEN_TPU_JAX_PROFILE", "1")
    with trace.profile_session(tmp_path / "on") as ps:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    evs = json.loads(ps.path.read_text())["traceEvents"]
    assert ps.path == tmp_path / "on" / "trace.json"
    assert any("mm" in str(e.get("name")) for e in evs)


# -- the flight recorder (tests/test_obs.py's cases) -----------------------

def test_emit_is_noop_until_installed(tmp_path):
    assert obs.emit("sweep_start", checker="append") is False
    assert obs.install_events(tmp_path) == tmp_path / "events.jsonl"
    assert obs.emit("sweep_start", checker="append") is True
    obs.reset_events()
    assert obs.emit("sweep_end", exit_code=0) is False
    evs = obs.load_events(tmp_path)
    assert [e["event"] for e in evs] == ["sweep_start"]
    assert evs[0]["checker"] == "append"
    assert evs[0]["t_mono"] > 0 and evs[0]["t_wall"] > 0


def test_emit_rejects_undeclared_kind(tmp_path):
    obs.install_events(tmp_path)
    with pytest.raises(ValueError):
        obs.emit("sweep_strat")


def test_event_kinds_are_the_reference_s():
    assert obs.EVENT_KINDS == ref_obs_kinds()


def ref_obs_kinds():
    from jepsen_tpu.obs import events as ref_events
    return ref_events.EVENT_KINDS


def test_load_events_skips_torn_tail(tmp_path):
    obs.install_events(tmp_path)
    obs.emit("sweep_start", checker="wr")
    obs.emit("sweep_end", exit_code=0)
    with open(obs.events.current_path(), "a") as f:
        f.write('{"event": "quarant')
    assert [e["event"] for e in obs.load_events(tmp_path)] == \
        ["sweep_start", "sweep_end"]


def test_events_rotation_default_off(tmp_path):
    obs.install_events(tmp_path)
    for i in range(50):
        obs.emit("sweep_start", checker="append", runs=i)
    assert not (tmp_path / "events.jsonl.1").exists()
    assert len(obs.load_events(tmp_path)) == 50


def test_events_rotate_at_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_EVENTS_MAX_BYTES", "400")
    obs.install_events(tmp_path)
    for i in range(40):
        obs.emit("sweep_start", checker="append", runs=i)
    rotated = tmp_path / "events.jsonl.1"
    old = obs.load_events(rotated)
    assert old and all(e["event"] in ("sweep_start", "events_rotated")
                       for e in old)
    live = obs.load_events(tmp_path)
    assert live[0]["event"] == "events_rotated"
    assert live[0]["rotated_to"] == "events.jsonl.1"
    assert live[0]["size"] >= 400
    seen = [e["runs"] for e in old + live if e["event"] == "sweep_start"]
    assert seen == sorted(seen) and seen[-1] == 39
    assert (tmp_path / "events.jsonl").stat().st_size < 800


def test_events_rotation_keeps_one_generation(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_EVENTS_MAX_BYTES", "300")
    obs.install_events(tmp_path)
    for i in range(120):
        obs.emit("sweep_start", checker="append", runs=i)
    assert sorted(p.name for p in tmp_path.glob("events.jsonl*")) == \
        ["events.jsonl", "events.jsonl.1"]


# -- the report and the search section, on the same inputs -----------------

def synthetic_timeline() -> list:
    """A Chrome event list with every stage mapping: parent phases, a
    device window with gaps, nested detail spans and an instant."""
    tr = trace.Tracer(run="timeline")
    t = time.perf_counter()
    spans = [("parse", 0.0, 0.004), ("pack", 0.004, 0.006),
             ("h2d", 0.006, 0.007), ("dispatch", 0.007, 0.0075),
             ("parse", 0.0075, 0.012), ("collect", 0.012, 0.016),
             ("pack", 0.013, 0.014), ("feed", 0.016, 0.017)]
    for name, a, b in spans:
        tr._complete(name, t + a, t + b, "phase", None)
    tr.device_complete("bucket", t + 0.0075, t + 0.015, histories=2)
    tr.device_complete("bucket", t + 0.0155, t + 0.0165, histories=1)
    tr.add_span("load_history", t + 0.001, t + 0.002)
    tr.instant("fault_inject", kind="encode", run="r")
    return tr.chrome_events()


def test_attribution_equals_the_reference_s():
    evs = synthetic_timeline()
    counters = {"runs_verdicted": 3, "buckets_dispatched": 2,
                "quarantined": 1}
    got = attribution.analyze(evs, counters=counters)
    assert got == ref_attr.analyze(evs, counters=counters)
    assert got["bound"] == "device"
    assert sum(got["shares"].values()) == pytest.approx(1.0, abs=0.02)
    assert attribution.summary_line(got) == ref_attr.summary_line(got)
    assert attribution.render_report_md(got) == \
        ref_attr.render_report_md(got)
    window = (1000.0, 14000.0)
    assert attribution.analyze(evs, window_us=window) == \
        ref_attr.analyze(evs, window_us=window)
    assert attribution.analyze([]) == ref_attr.analyze([])


def test_search_section_equals_the_reference_s():
    recs = [{"v": 1, "dir": f"t/r{i}", "checker": "append",
             "ww_edges": 10 + i, "wr_edges": 5, "rw_edges": 4,
             "rt_edges": 0, "proc_edges": 0, "closure_rounds": 3 + i % 2,
             "cycle_round": 2 if i % 3 == 0 else -1,
             "scc_count": 1 if i % 3 == 0 else 0,
             "scc_max": 2 if i % 3 == 0 else 0, "scc_min": 0,
             "cycle_txns": 2 if i % 3 == 0 else 0,
             "margin": 2 if i % 3 == 0 else 3 + i % 2, "n_txns": 100,
             "t_pad": 128 * (1 + i % 2), "closure_bound": 7,
             "pad_waste_cells": 6384} for i in range(7)]
    recs.append({"v": 1, "dir": "reg/r0", "checker": "register",
                 "keys": 3, "engines": ["tpu-dense", "wgl-native"],
                 "configs": 40, "rounds": 12, "frontier_peak": 9,
                 "max_depth": 20})
    got = search.search_section(recs)
    assert got == ref_search.search_section(recs)
    assert got["anomalous"] == 3 and got["register"]["keys"] == 3
    assert search.render_search_md(got) == ref_search.render_search_md(got)
    assert search.search_section([]) is None


def test_search_ledger_sampling_and_near_miss(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_KERNEL_STATS", "1")
    monkeypatch.setenv("JEPSEN_TPU_KERNEL_STATS_SAMPLE", "2")
    tr = trace.fresh_run("ledger")
    for i in range(5):
        search.record(f"d{i}", "append",
                      {"cycle_txns": 2, "margin": i, "closure_rounds": i,
                       "ww_edges": 1}, anomalies={"G1c": True})
    assert [r.get("near_miss", False) for r in search.records()] == \
        [False, False, True, True, True]
    assert search.flush(tmp_path / "a.jsonl") == 3
    assert [r["dir"] for r in load_analytics(tmp_path / "a.jsonl")] == \
        ["d0", "d2", "d4"]
    with open(tmp_path / "a.jsonl", "a") as f:
        f.write('{"v": 1, "dir": "torn"')
    assert len(load_analytics(tmp_path / "a.jsonl")) == 3
    c = tr.metrics_dict()["counters"]
    assert c["kernel.stats_records"] == c["kernel.cyclic_histories"] == 5
    monkeypatch.delenv("JEPSEN_TPU_KERNEL_STATS")
    assert search.flush(tmp_path / "b.jsonl") == 0
    assert not (tmp_path / "b.jsonl").exists()


# -- whole sweeps, both CLIs on one path in turn -----------------------------

TELEMETRY = ("trace.json", "metrics.json", "events.jsonl", "report.json",
             "report.md", "analytics.jsonl")


@pytest.fixture
def telemetry_env(reference_env, monkeypatch):  # noqa: F811
    # the reference's sweep dispatches on one device, as the port's
    # does: the tests' eight virtual CPU devices would pad each of its
    # buckets to a multiple of eight, which `pad_waste_cells`,
    # `h2d_bytes` and `bucket_cells` count
    import jax
    mesh = ref_parallel.make_mesh(jax.devices()[:1])
    monkeypatch.setattr(ref_parallel, "make_mesh", lambda *a, **k: mesh)
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    monkeypatch.setenv("JEPSEN_TPU_ENCODE_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_NATIVE_INGEST", "0")
    monkeypatch.setenv("JEPSEN_TPU_DONATE_BUFFERS", "0")
    monkeypatch.setenv("JEPSEN_TPU_KERNEL_STATS", "1")


def both(tmp_path, pristine, argv, capsys, rearm=None, pre=None) -> tuple:
    """Both CLIs over `pristine` on one path in turn; returns in_turn's
    result and, per package, the telemetry files each left. `pre` are
    in_turn steps run first (a warming sweep)."""
    grabbed = []

    def grab(store):
        grabbed.append({f: (store / f).read_bytes() for f in TELEMETRY
                        if (store / f).exists()})

    steps = (pre or []) + [(argv, None), grab]
    if rearm is not None:
        steps.insert(0, rearm)
    got = in_turn(tmp_path, pristine, steps, capsys)
    return got, dict(zip(("ref", "port"), grabbed))


def events_of(raw: bytes) -> list:
    return [{k: v for k, v in json.loads(ln).items()
             if k not in ("t_mono", "t_wall", "pid")}
            for ln in raw.decode().splitlines()]


def spans_of(raw: bytes, pooled: bool = False) -> tuple:
    """The trace's (name, category, phase) set and its track names;
    `pooled` writes a worker's pid in a track name as <pid> and folds
    the numbered lanes of a named track into the track."""
    evs = json.loads(raw)["traceEvents"]

    def track(name: str) -> str:
        if pooled:
            name = re.sub(r"-\d+$", "", re.sub(r" \d+$", " <pid>", name))
        return name
    return ({(e["name"], e.get("cat"), e["ph"]) for e in evs
             if e["ph"] != "M"},
            {track(e["args"]["name"]) for e in evs if e["ph"] == "M"})


def assert_same_telemetry(tele: dict, pooled: bool = False) -> dict:
    ref, port = tele["ref"], tele["port"]
    assert sorted(ref) == sorted(port)
    if "analytics.jsonl" in ref:
        assert ref["analytics.jsonl"] == port["analytics.jsonl"]
    assert events_of(ref["events.jsonl"]) == events_of(port["events.jsonl"])
    mr = json.loads(ref["metrics.json"])
    mp = json.loads(port["metrics.json"])
    assert mr["counters"] == mp["counters"]
    if pooled:
        # how deep the reorder buffer got depends on arrival order
        assert ("reorder_depth" in mr["gauges"]) == \
            ("reorder_depth" in mp["gauges"])
        for m in (mr, mp):
            m["gauges"].pop("reorder_depth", None)
    assert mr["gauges"] == mp["gauges"]
    assert sorted(mr["histograms"]) == sorted(mp["histograms"])
    for h in ("bucket_cells", "kernel.closure_rounds", "kernel.edges",
              "kernel.margin", "kernel.scc_max"):
        if h in mr["histograms"]:
            assert mr["histograms"][h] == mp["histograms"][h], h
    sr, tr_ = spans_of(ref["trace.json"], pooled)
    sp, tp = spans_of(port["trace.json"], pooled)
    assert sr == sp
    assert tr_ == tp
    if "report.json" in ref:
        rr, rp = json.loads(ref["report.json"]), json.loads(
            port["report.json"])
        assert sorted(rr) == sorted(rp)
        assert sorted(rr["shares"]) == sorted(rp["shares"])
        assert sorted(rr["stalls"]) == sorted(rp["stalls"])
        assert rr.get("search") == rp.get("search")
        if "counters" in rr:        # a timeline to attribute
            assert rr["counters"] == rp["counters"]
    return mp


def append_store(base):
    synth.write_synth_run_store(base, B=6, T=120, K=8, bad_every=3)


def wr_store(base):
    synth.write_wr_run_store(base, B=4, T=60, K=4, bad_every=2)


@pytest.mark.parametrize("kind", [
    "append", "wr", "long", "register", "native-append-cold",
    "native-append-warm", "native-wr-cold", "native-wr-warm",
    "pooled-append", "pooled-wr", "pooled-register"])
def test_sweep_telemetry_matches_reference(kind, tmp_path, telemetry_env,
                                           monkeypatch, capsys):
    pristine = tmp_path / "pristine"
    warm = None
    pooled = kind.startswith("pooled-")
    if pooled:
        # two workers in each package's pool, spawned also where
        # pytest-xdist runs this (test_torch_pool.spawn_anywhere)
        from test_torch_pool import spawn_anywhere
        monkeypatch.setattr(os, "cpu_count", lambda: 2)
        spawn_anywhere(monkeypatch)
        kind = kind.split("-")[1]
    if kind.startswith("native-"):
        # the encode cache and the native encoder at their defaults
        monkeypatch.delenv("JEPSEN_TPU_ENCODE_CACHE")
        monkeypatch.delenv("JEPSEN_TPU_NATIVE_INGEST")
        _, kind, warmth = kind.split("-")
        if warmth == "warm":
            def warm(store):
                # a first sweep leaves the package's own sidecars; its
                # telemetry, verdicts and summary lines are cleared
                capsys.readouterr()
                for f in TELEMETRY + ("verdicts.jsonl",):
                    (store / f).unlink(missing_ok=True)
                for p in list(store.rglob("results.*")) \
                        + list(store.rglob(".sweep-*")):
                    p.unlink()
    checker = {"long": "append"}.get(kind, kind)
    if kind == "long":
        # every run takes the condensed path in both packages
        monkeypatch.setattr(ref_parallel, "DENSE_TXN_LIMIT", 100)
        monkeypatch.setattr(port_parallel, "DENSE_TXN_LIMIT", 100)
        synth.write_synth_run_store(pristine, B=3, T=200, K=8, bad_every=2)
    else:
        {"append": append_store, "wr": wr_store,
         "register": register_store}[kind](pristine)
    argv = ["--checker", checker, "--report"]
    got, tele = both(tmp_path, pristine, argv, capsys,
                     pre=[(argv, None), warm] if warm else None)
    assert_same(got)
    m = assert_same_telemetry(tele, pooled)
    if pooled and kind != "register":
        # every run parsed in a worker, each worker its own pid track
        c = m["counters"]
        assert c["worker_spans"] >= len(got["port"][2]) and c["shm_bytes"]
        assert "ingest-worker <pid>" in spans_of(
            tele["port"]["trace.json"], pooled=True)[1]
    if warm is not None:
        c = m["counters"]
        assert c["cache_hits"] == len(got["port"][2])
        assert "cache_misses" not in c
        spans, _ = spans_of(tele["port"]["trace.json"])
        assert ("cache_probe", "span", "X") in spans
        assert ("encode_native", "span", "X") not in spans
    recs = [json.loads(ln) for ln in
            tele["port"]["analytics.jsonl"].decode().splitlines()]
    assert recs and all(r["checker"] == checker for r in recs)
    assert m["counters"]["runs_verdicted"] == \
        m["gauges"]["runs_total"] == len(got["port"][2])
    if kind == "append":
        assert m["counters"]["buckets_dispatched"] >= 1
        assert any(r["cycle_txns"] for r in recs)
    if kind == "long":
        assert all(r["path"] == "condensed" for r in recs)
        assert any(r["scc_count"] for r in recs)
    if kind == "register":
        engines = {e for r in recs for e in r["engines"]}
        assert {"tpu-dense", "tpu-jit", "wgl-native"} <= engines


def test_fault_injected_sweep_telemetry_matches_reference(
        tmp_path, telemetry_env, monkeypatch, capsys):
    """Under encode:0.4,oom:first: the same quarantine and oom_split
    events in order, the same counters, and a `quarantine` span."""
    pristine = tmp_path / "pristine"
    # the nemesis picks run-00012 to run-00015 of these
    synth.write_synth_run_store(pristine, B=16, T=40, K=6, bad_every=4)
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", "encode:0.4,oom:first")

    def rearm(_store):
        sv.reset_injection()
        ref_sv.reset_injection()

    got, tele = both(tmp_path, pristine, ["--checker", "append"], capsys,
                     rearm=rearm)
    assert_same(got)
    m = assert_same_telemetry(tele)
    kinds = [e["event"] for e in events_of(tele["port"]["events.jsonl"])]
    assert kinds[0] == "sweep_start" and "oom_split" in kinds
    assert kinds.count("quarantine") == m["counters"]["quarantined"] == 4
    assert m["counters"]["oom_retries"] == m["counters"]["bucket_splits"]
    spans, _ = spans_of(tele["port"]["trace.json"])
    assert ("quarantine", "span", "X") in spans
    assert ("fault_inject", "instant", "i") in spans


def test_resume_emits_sweep_resume_like_the_reference(
        tmp_path, telemetry_env, capsys):
    pristine = tmp_path / "pristine"
    synth.write_synth_run_store(pristine, B=2, T=40, K=4, bad_every=0)
    grabbed = []
    got = in_turn(tmp_path, pristine, [
        (["--checker", "append"], None), (["--checker", "append",
                                           "--resume"], None),
        lambda s: grabbed.append((s / "events.jsonl").read_bytes())],
        capsys)
    assert_same(got)
    ref, port = (events_of(g) for g in grabbed)
    assert ref == port
    assert [e for e in port if e["event"] == "sweep_resume"] == [
        {"event": "sweep_resume", "skipped": 2, "pending": 0}]


def test_gates_unset_change_no_verdict_and_trace_off_writes_no_trace(
        tmp_path, reference_env, monkeypatch, capsys):  # noqa: F811
    """With the gates unset the verdict files are the reference's and
    no analytics or report is written; with JEPSEN_TPU_TRACE=0 neither
    trace.json nor metrics.json is written, events.jsonl still is, and
    --report says why it is skipped."""
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    pristine = tmp_path / "pristine"
    append_store(pristine)
    got, tele = both(tmp_path, pristine, ["--checker", "append"], capsys)
    assert_same(got)
    assert sorted(tele["port"]) == ["events.jsonl", "metrics.json",
                                    "trace.json"]
    monkeypatch.setenv("JEPSEN_TPU_TRACE", "0")
    store = tmp_path / "off"
    append_store(store)
    rc = cli.main(["analyze-store", "--store", str(store), "--report",
                   "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "attribution report needs tracing on" in err
    assert not any((store / f).exists() for f in
                   ("trace.json", "metrics.json", "report.json"))
    assert [e["event"] for e in obs.load_events(store)] == \
        ["sweep_start", "sweep_end"]


def test_stats_sweep_verdicts_equal_stats_off_sweep(tmp_path, monkeypatch,
                                                    capsys):
    """The stats gate changes no verdict byte and no closure launch
    count (the plain squaring counts its calls here)."""
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    outs = {}
    for stats in ("0", "1"):
        calls = []

        def square(m, mT, active=None):
            calls.append(1)
            return cs.closure_square_ref(m, mT, active)

        monkeypatch.setenv("JEPSEN_TPU_KERNEL_STATS", stats)
        store = tmp_path / f"s{stats}"
        append_store(store)
        log: list = []
        rc = cli.analyze_store(Store(store), "append", device="cpu",
                               square=square, bucket_log=log)
        outs[stats] = (rc, len(calls), [b["closure_rounds"] for b in log],
                       {p.relative_to(store).as_posix(): p.read_bytes()
                        for p in store.rglob("results.*")})
    capsys.readouterr()
    assert outs["0"] == outs["1"]
    assert outs["0"][0] == 1 and outs["0"][1] > 0
    assert (tmp_path / "s1" / "analytics.jsonl").exists()
    assert not (tmp_path / "s0" / "analytics.jsonl").exists()

"""The port's live telemetry (jepsen_tpu_torch.obs.health and .prom)
against the reference's, on the CPU.

tests/test_obs.py's health and Prometheus cases pointed at the port:
the snapshot's shape and arithmetic, its nulls on the null tracer, the
sampler's gate, atomic writes under a concurrent reader, the exposition
held to tests/golden_metrics.prom, the `/metrics` and `/healthz`
endpoint and its gate. Each snapshot and page is also computed by the
reference from a tracer fed the same operations and must agree: the
same keys at every level and the same nulls (the snapshot), the same
bytes (the page). The endpoint binds 127.0.0.1 on an ephemeral port and
is scraped with urllib, each wait bounded by a few seconds.

Then sweeps: with JEPSEN_TPU_HEALTH_INTERVAL_S and
JEPSEN_TPU_METRICS_PORT=0 both CLIs on one store path in turn leave a
health.json with the reference's keys, nulls and progress (every run
verdicted), a scrape during the sweep answers, and the verdicts are
byte-identical to a sweep with the gates off."""

import json
import os
import socket
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jepsen_tpu.obs.health as ref_health
import jepsen_tpu.obs.prom as ref_prom
import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu.trace as ref_trace
from jepsen_tpu_torch import cli, obs, trace
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.obs import device as device_obs
from jepsen_tpu_torch.obs.health import (HealthSampler, health_snapshot,
                                         maybe_start_health_sampler)
from jepsen_tpu_torch.obs.prom import (MetricsServer,
                                       maybe_start_metrics_server,
                                       render_prometheus)
from test_torch_cli import reference_env  # noqa: F401
from test_torch_stored import in_turn

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 5


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for g in ("JEPSEN_TPU_HEALTH_INTERVAL_S", "JEPSEN_TPU_METRICS_PORT",
              "JEPSEN_TPU_COSTDB", "JEPSEN_TPU_FAULT_INJECT"):
        monkeypatch.delenv(g, raising=False)
    obs.reset_events()
    trace.reset()
    device_obs.reset()
    yield
    obs.reset_events()
    trace.reset()
    device_obs.reset()


def both_tracers(ops) -> tuple:
    """A port tracer and a reference tracer fed the same operations:
    (kind, name, value) — counter increments, gauge sets, histogram
    observations."""
    pair = (trace.Tracer(run="twin"), ref_trace.Tracer(run="twin"))
    for kind, name, v in ops:
        for tr in pair:
            if kind == "c":
                tr.counter(name).inc(v)
            elif kind == "g":
                tr.gauge(name).set(v)
            else:
                tr.histogram(name).observe(v)
    return pair


def seeded_ops(seed: int) -> list:
    rng = np.random.default_rng(seed)
    names = {"c": ["runs_verdicted", "buckets_dispatched",
                   "buckets_resolved", "quarantined", "oom_retries",
                   "bucket_splits", "watchdog_timeouts", "cost_records",
                   "h2d_bytes"],
             "g": ["runs_total", "inflight_depth", "resident_executables",
                   "hbm_modeled_bytes", "hbm_device_bytes"],
             "h": ["bucket_cells", "phase.pack", "device.bucket"]}
    ops = []
    for _ in range(int(rng.integers(5, 40))):
        kind = str(rng.choice(["c", "g", "h"]))
        name = str(rng.choice(names[kind]))
        if kind == "c":
            v = int(rng.integers(1, 50))
        elif kind == "g":
            v = None if rng.random() < 0.1 else int(rng.integers(0, 10 ** 9))
        else:
            v = float(rng.uniform(1e-4, 1e6))
        ops.append((kind, name, v))
    return ops


def shape(d):
    """The snapshot's keys at every level, with None where a value is
    null."""
    if isinstance(d, dict):
        return {k: shape(v) for k, v in d.items()}
    return None if d is None else type(d).__name__


# -- health.json --------------------------------------------------------------

def test_health_snapshot_shape_and_math():
    tr = trace.Tracer(run="unit")
    tr.gauge("runs_total").set(10)
    tr.counter("runs_verdicted").inc(5)
    tr.counter("buckets_dispatched").inc(4)
    tr.counter("buckets_resolved").inc(3)
    tr.counter("quarantined").inc(2)
    snap = health_snapshot(tr, seq=7, started_mono=time.monotonic() - 10.0)
    assert snap["v"] == 1 and snap["run"] == "unit"
    assert snap["heartbeat"]["seq"] == 7
    p = snap["progress"]
    assert (p["runs_total"], p["runs_verdicted"]) == (10, 5)
    assert (p["buckets_dispatched"], p["buckets_resolved"]) == (4, 3)
    assert snap["robustness"]["quarantined"] == 2
    assert snap["robustness"]["watchdog_timeouts"] == 0
    t = snap["throughput"]
    assert t["elapsed_secs"] == pytest.approx(10.0, abs=1.0)
    assert t["runs_per_sec"] == pytest.approx(0.5, rel=0.15)
    assert t["eta_secs"] == pytest.approx(10.0, rel=0.2)


@pytest.mark.parametrize("seed", range(5))
def test_health_snapshot_keys_and_nulls_are_the_reference_s(seed):
    mine, ref = both_tracers(seeded_ops(seed))
    t0 = time.monotonic() - 3.0
    a = health_snapshot(mine, seq=4, started_mono=t0, extra={"x": 1})
    b = ref_health.health_snapshot(ref, seq=4, started_mono=t0,
                                   extra={"x": 1})
    assert shape(a) == shape(b)
    for k in ("v", "run", "progress", "robustness", "device", "x"):
        assert a[k] == b[k], k


def test_health_snapshot_null_tracer_all_null_fields():
    a = health_snapshot(trace.NullTracer(), seq=1)
    b = ref_health.health_snapshot(ref_trace.NullTracer(), seq=1)
    assert shape(a) == shape(b)
    assert a["progress"]["runs_total"] is None
    assert a["progress"]["runs_verdicted"] == 0
    assert a["throughput"]["eta_secs"] is None
    assert a["device"] == {"resident_executables": None,
                           "hbm_modeled_bytes": None,
                           "hbm_device_bytes": None, "donated_bytes": None}


def test_health_sampler_gate(monkeypatch, tmp_path):
    assert maybe_start_health_sampler(tmp_path) is None
    for off in ("0", "-1", "not-a-number"):
        monkeypatch.setenv("JEPSEN_TPU_HEALTH_INTERVAL_S", off)
        assert maybe_start_health_sampler(tmp_path) is None
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_INTERVAL_S", "0.01")
    tr = trace.Tracer(run="gated")
    s = maybe_start_health_sampler(tmp_path, tracer_fn=lambda: tr)
    try:
        assert s is not None and (tmp_path / "health.json").is_file()
    finally:
        s.stop()
    assert json.loads((tmp_path / "health.json").read_text())["run"] == \
        "gated"


def test_health_atomic_under_concurrent_reader(tmp_path):
    tr = trace.Tracer(run="atomic")
    sampler = HealthSampler(tmp_path, 0.002, tracer_fn=lambda: tr).start()
    seqs = []
    deadline = time.monotonic() + 0.5
    try:
        while time.monotonic() < deadline:
            try:
                text = (tmp_path / "health.json").read_text()
            except FileNotFoundError:
                continue
            seqs.append(json.loads(text)["heartbeat"]["seq"])
    finally:
        sampler.stop()
    assert len(seqs) > 10 and seqs == sorted(seqs) and seqs[-1] > seqs[0]
    assert not list(tmp_path.glob(".health.json.*"))


def test_sampler_extra_section_and_final_snapshot(tmp_path):
    tr = trace.Tracer(run="x")
    s = HealthSampler(tmp_path, 60.0, tracer_fn=lambda: tr,
                      extra_fn=lambda: {"serve": {"q": 1}}).start()
    tr.counter("runs_verdicted").inc(3)
    s.stop()
    snap = json.loads((tmp_path / "health.json").read_text())
    assert snap["serve"] == {"q": 1}
    assert snap["progress"]["runs_verdicted"] == 3
    assert snap["heartbeat"]["seq"] == 2        # start + final


def test_write_health_is_best_effort(tmp_path):
    from jepsen_tpu_torch.obs.health import write_health
    (tmp_path / "a-file").write_text("")
    assert write_health(tmp_path / "a-file" / "health.json", {}) is None
    assert write_health(tmp_path / "health.json", {"v": 1}) == \
        tmp_path / "health.json"


# -- Prometheus ---------------------------------------------------------------

def make_golden_tracer(mod=trace):
    tr = mod.Tracer(run="golden")
    tr.counter("quarantined").inc(3)
    tr.counter("buckets_dispatched").inc(5)
    tr.gauge("inflight_depth").set(2)
    tr.gauge("runs_total").set(None)    # unset gauge must not render
    h = tr.histogram("bucket_cells")
    for v in (1.0, 3.0, 100.0):
        h.observe(v)
    return tr


def test_prometheus_exposition_golden_file():
    got = render_prometheus(make_golden_tracer())
    assert got == (REPO / "tests" / "golden_metrics.prom").read_text()
    assert got == ref_prom.render_prometheus(make_golden_tracer(ref_trace))


@pytest.mark.parametrize("seed", range(5))
def test_prometheus_page_is_the_reference_s(seed):
    mine, ref = both_tracers(seeded_ops(seed))
    assert render_prometheus(mine) == ref_prom.render_prometheus(ref)


def test_prometheus_counters_match_metrics_dict():
    tr = make_golden_tracer()
    page = render_prometheus(tr)
    for name, v in tr.metrics_dict()["counters"].items():
        assert f"jepsen_tpu_{name} {v}" in page
    assert 'jepsen_tpu_bucket_cells_bucket{le="+Inf"} 3' in page
    assert "jepsen_tpu_bucket_cells_count 3" in page


def test_null_tracer_renders_an_empty_page():
    assert render_prometheus(trace.NullTracer()) == "\n" == \
        ref_prom.render_prometheus(ref_trace.NullTracer())


def fetch(url: str):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.headers["Content-Type"], r.read().decode()


def test_metrics_server_scrapes_and_stops():
    tr = make_golden_tracer()
    srv = MetricsServer(0, host="127.0.0.1", tracer_fn=lambda: tr)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        ctype, page = fetch(base + "/metrics")
        assert ctype.startswith("text/plain") and page == \
            render_prometheus(tr)
        ctype, body = fetch(base + "/healthz?x=1")
        assert ctype == "application/json"
        snap = json.loads(body)
        assert snap["v"] == 1 and snap["run"] == "golden"
        assert json.loads(fetch(base + "/health")[1])["run"] == "golden"
        with pytest.raises(urllib.error.HTTPError) as ei:
            fetch(base + "/nope")
        assert ei.value.code == 404
    finally:
        srv.stop()
    with pytest.raises(OSError):
        fetch(base + "/metrics")


def test_metrics_server_serves_the_health_fn():
    srv = MetricsServer(0, host="127.0.0.1",
                        health_fn=lambda: {"v": 1, "custom": True})
    try:
        assert json.loads(fetch(
            f"http://127.0.0.1:{srv.port}/healthz")[1])["custom"] is True
    finally:
        srv.stop()


def test_metrics_server_gate(monkeypatch):
    assert maybe_start_metrics_server() is None
    monkeypatch.setenv("JEPSEN_TPU_METRICS_PORT", "-1")
    assert maybe_start_metrics_server() is None
    monkeypatch.setenv("JEPSEN_TPU_METRICS_PORT", "0")
    srv = maybe_start_metrics_server()
    try:
        assert srv is not None and srv.port > 0
    finally:
        srv.stop()


def test_a_port_that_cannot_bind_degrades_to_a_warning(monkeypatch, caplog):
    with socket.socket() as held:
        held.bind(("0.0.0.0", 0))
        held.listen(1)
        monkeypatch.setenv("JEPSEN_TPU_METRICS_PORT",
                           str(held.getsockname()[1]))
        assert maybe_start_metrics_server() is None
    assert "failed to bind" in caplog.text


def test_obs_package_exports_the_reference_s_names():
    import jepsen_tpu.obs as ref_obs
    assert set(obs.__all__) == set(ref_obs.__all__) | {"search"}
    for name in ("maybe_start_health_sampler", "maybe_start_metrics_server",
                 "health_snapshot", "render_prometheus", "HealthSampler",
                 "MetricsServer"):
        assert callable(getattr(obs, name))


# -- sweeps -------------------------------------------------------------------

def serial(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 1)


def test_obs_off_by_default(tmp_path, capsys, monkeypatch):
    serial(monkeypatch)
    synth.write_synth_run_store(tmp_path / "s", B=2, T=40, K=4, bad_every=0)
    assert cli.main(["analyze-store", "--store", str(tmp_path / "s"),
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    assert not (tmp_path / "s" / "health.json").exists()
    kinds = {e["event"] for e in obs.load_events(tmp_path / "s")}
    assert "metrics_serve" not in kinds and "health_sample" not in kinds
    assert {"sweep_start", "sweep_end"} <= kinds


def test_sweep_with_gates_produces_live_artifacts(tmp_path, capsys,
                                                  monkeypatch):
    """A scrape of both endpoints through the sweep's hook answers; the
    final health.json records full progress; the scraped counter names
    are metrics.json's."""
    from jepsen_tpu_torch.store import Store
    serial(monkeypatch)
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_INTERVAL_S", "0.05")
    monkeypatch.setenv("JEPSEN_TPU_METRICS_PORT", "0")
    synth.write_synth_run_store(tmp_path / "s", B=3, T=40, K=4, bad_every=0)
    scraped = {}

    def hook(server, sampler):
        assert server is not None and sampler is not None
        base = f"http://127.0.0.1:{server.port}"
        scraped["metrics"] = fetch(base + "/metrics")[1]
        scraped["healthz"] = json.loads(fetch(base + "/healthz")[1])

    assert cli.analyze_store(Store(tmp_path / "s"), "append", device="cpu",
                             obs_hook=hook) == 0
    capsys.readouterr()
    assert scraped["healthz"]["v"] == 1
    assert "jepsen_tpu_shm_stale_reclaimed " in scraped["metrics"]
    health = json.loads((tmp_path / "s" / "health.json").read_text())
    p = health["progress"]
    assert p["runs_total"] == p["runs_verdicted"] == 3
    assert p["buckets_dispatched"] == p["buckets_resolved"]
    final = json.loads((tmp_path / "s" / "metrics.json").read_text())
    assert final["counters"]["runs_verdicted"] == 3
    kinds = [e["event"] for e in obs.load_events(tmp_path / "s")]
    assert kinds.count("metrics_serve") == 1
    assert kinds.count("health_sample") == 2     # first and final


def test_the_server_and_sampler_stop_when_the_sweep_raises(
        tmp_path, capsys, monkeypatch):
    from jepsen_tpu_torch import cli as port_cli
    from jepsen_tpu_torch.store import Store
    serial(monkeypatch)
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_INTERVAL_S", "0.05")
    monkeypatch.setenv("JEPSEN_TPU_METRICS_PORT", "0")
    synth.write_synth_run_store(tmp_path / "s", B=2, T=40, K=4, bad_every=0)
    up = {}

    def hook(server, sampler):
        up["server"], up["sampler"] = server, sampler

    def boom(*a, **k):
        raise RuntimeError("the sweep failed")
    monkeypatch.setattr(port_cli, "_analyze_store_impl", boom)
    with pytest.raises(RuntimeError):
        cli.analyze_store(Store(tmp_path / "s"), "append", device="cpu",
                          obs_hook=hook)
    capsys.readouterr()
    assert not up["sampler"]._thread.is_alive()
    assert not up["server"]._thread.is_alive()
    with pytest.raises(OSError):
        fetch(f"http://127.0.0.1:{up['server'].port}/metrics")


@pytest.fixture
def obs_env(reference_env, monkeypatch):  # noqa: F811
    import jax
    mesh = ref_parallel.make_mesh(jax.devices()[:1])
    monkeypatch.setattr(ref_parallel, "make_mesh", lambda *a, **k: mesh)
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    monkeypatch.setenv("JEPSEN_TPU_DONATE_BUFFERS", "0")


@pytest.mark.parametrize("kind", ["append", "wr"])
def test_sweep_health_matches_the_reference(kind, tmp_path, obs_env,
                                            monkeypatch, capsys):
    pristine = tmp_path / "pristine"
    if kind == "append":
        synth.write_synth_run_store(pristine, B=6, T=120, K=8, bad_every=3)
    else:
        synth.write_wr_run_store(pristine, B=4, T=60, K=4, bad_every=2)
    argv = ["--checker", kind]
    off = in_turn(tmp_path / "off", pristine, [(argv, None)], capsys)
    for k, v in (("JEPSEN_TPU_HEALTH_INTERVAL_S", "0.2"),
                 ("JEPSEN_TPU_METRICS_PORT", "0"),
                 ("JEPSEN_TPU_COSTDB", "1")):
        monkeypatch.setenv(k, v)
    grabbed = []
    on = in_turn(tmp_path / "on", pristine, [
        (argv, None),
        lambda s: grabbed.append(json.loads((s / "health.json").read_text()))],
        capsys)
    for pkg in ("ref", "port"):
        assert on[pkg][:2] == off[pkg][:2] == off["ref"][:2]
    ref, port = grabbed
    assert shape(port) == shape(ref)
    n_runs = len(on["port"][2])
    for snap in (ref, port):
        assert snap["progress"]["runs_verdicted"] == n_runs
        assert snap["progress"]["runs_total"] == n_runs
    assert port["progress"] == ref["progress"]
    assert port["robustness"] == ref["robustness"]
    assert port["device"]["donated_bytes"] is None
    assert port["device"]["hbm_device_bytes"] is None     # no card

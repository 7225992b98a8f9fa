"""The port's device cost observatory (jepsen_tpu_torch.obs.device) and
costdb (jepsen_tpu_torch.store) against the reference's, on the CPU.

tests/test_costdb.py's cases pointed at the port — the peak table, the
record's shape and dedup, the costdb file discipline (flushed lines,
torn tails skipped and sealed, a SIGKILLed writer), the shard merge,
the report's device section — plus the port's own contract: `cost`
counted from the closure's shapes and rounds, windows keyed by the
dispatch object, a CUDA error met by the observatory ending the sweep.

Then whole sweeps: a small append store and a small wr store swept by
both CLIs on one path in turn (tests/test_torch_stored.py's `in_turn`),
the reference with `JEPSEN_TPU_AOT_CACHE=0`, a private compile cache,
one device, one core and buffer donation off. With
`JEPSEN_TPU_COSTDB=1` the verdict files are byte-identical to the gate
off, and the costdb records agree in `kernel`, `geometry`,
`windows.dispatches`, `windows.histories`, `donated` and `provenance`
(`cost` and the seconds are the packages' own). The wr sweep writes no
costdb in either package: its edge batches are not an observed dispatch
in the reference.

Tolerance: exact, but for floats derived from the same inputs (1e-9
relative)."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jepsen_tpu.obs.attribution as ref_attr
import jepsen_tpu.obs.device as ref_device
import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu.store as ref_store
from jepsen_tpu_torch import _build, cli, parallel, trace
from jepsen_tpu_torch import store as port_store
from jepsen_tpu_torch.checker.elle import kernels as K
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.elle.encode import encode_history
from jepsen_tpu_torch.obs import attribution, health
from jepsen_tpu_torch.obs import device as device_obs
from test_torch_cli import reference_env  # noqa: F401
from test_torch_stored import in_turn

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    from jepsen_tpu import planner as ref_planner
    from jepsen_tpu_torch import planner
    for g in ("JEPSEN_TPU_COSTDB", "JEPSEN_TPU_PLANNER",
              "JEPSEN_TPU_HEALTH_INTERVAL_S", "JEPSEN_TPU_METRICS_PORT",
              "JEPSEN_TPU_KERNEL_STATS", "JEPSEN_TPU_FAULT_INJECT"):
        monkeypatch.delenv(g, raising=False)
    device_obs.reset()
    trace.reset()
    yield
    device_obs.reset()
    trace.reset()
    planner.deactivate()
    ref_planner.deactivate()


def hists(n=4, T=40, K_=4, g1c_every=0):
    return [synth.synth_append_history(
        T=T, K=K_, seed=i, g1c=bool(g1c_every) and i % g1c_every == 0)
        for i in range(n)]


def encs(n=4, T=40, K_=4, g1c_every=0):
    return [encode_history(h) for h in hists(n, T, K_, g1c_every)]


def cpu_sweep(es, **kw):
    return parallel.check_bucketed(es, CPU, **kw)


# -- the peak table -----------------------------------------------------------

def test_h100_row_from_the_table():
    p = K.device_peak(H100)
    assert p == {"device_kind": H100, "source": "table",
                 "bf16_tflops": 989.0, "int8_tops": 1979.0,
                 "hbm_gbps": 3350.0, "hbm_gib": 80.0}


def test_peak_kind_is_case_and_space_insensitive():
    assert K.device_peak(f"  {H100.lower()} ")["source"] == "table"


@pytest.mark.parametrize("kind", ["cpu", "unknown", "tpu v5 lite",
                                  "NVIDIA A100-SXM4-80GB"])
def test_unknown_kind_falls_back_flagged(kind):
    p = K.device_peak(kind)
    assert p["device_kind"] == kind
    assert p["source"] == f"fallback (assumed {H100})"
    assert p["int8_tops"] == 1979.0 and p["hbm_gbps"] == 3350.0
    # the table holds the card's row and no TPU row
    assert list(K.DEVICE_PEAKS) == [H100.lower()]


def test_default_kind_without_a_card_is_unknown(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert K.device_peak()["device_kind"] == "unknown"


def test_key_layout_is_the_reference_s():
    assert device_obs._KEY_FIELDS == ref_device._KEY_FIELDS
    shape = K.BatchShape(n_txns=128, n_appends=8, n_reads=8, n_keys=8,
                         max_pos=8)
    kw = dict(classify=True, realtime=False, process_order=False,
              fused=True, square=None)
    key = device_obs.dispatch_cost_key(kw, shape, False, CPU)
    assert len(key) == len(device_obs._KEY_FIELDS)
    assert key == (True, False, False, True, False, False, False, 8, 8,
                   128)
    cuda = device_obs.dispatch_cost_key(kw, shape, True,
                                        torch.device("cuda", 0))
    assert cuda[4:7] == (True, True, False) and cuda[-1] == "stats"


@pytest.mark.parametrize("dev,square,want", [
    ("cuda", None, "cuda-int8"), ("cpu", None, "closure_square_ref"),
    ("cuda", "ref", "closure_square_ref")])
def test_formulation_names_the_route(dev, square, want):
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    sq = cs.closure_square_ref if square else None
    assert device_obs.formulation(torch.device(dev), sq) == want


# -- capture on a CPU sweep ---------------------------------------------------

def ref_records(hs, monkeypatch, tmp_path):
    """The reference's records of the same histories, on one device."""
    import jax
    from jepsen_tpu.checker.elle import encode as r_encode
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("JEPSEN_TPU_DONATE_BUFFERS", "0")
    ref_device.reset()
    try:
        ref_parallel.check_bucketed(
            [r_encode.encode_history(h) for h in hs],
            ref_parallel.make_mesh(jax.devices()[:1]))
        return ref_device.records()
    finally:
        ref_device.reset()


def test_record_has_the_reference_s_keys(monkeypatch, tmp_path):
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    hs = hists()
    cpu_sweep([encode_history(h) for h in hs])
    (mine,) = device_obs.records()
    (ref,) = ref_records(hs, monkeypatch, tmp_path)
    assert list(mine) == list(ref)
    for k in ("windows", "peak", "achieved", "roofline", "geometry",
              "kernel"):
        assert sorted(mine[k]) == sorted(ref[k]), k
    assert sorted(mine["cost"]) == sorted(ref["cost"])
    for k in ("kernel", "geometry", "donated", "provenance", "backend",
              "device_kind"):
        assert mine[k] == ref[k], k
    assert mine["windows"]["dispatches"] == ref["windows"]["dispatches"]
    assert mine["windows"]["histories"] == ref["windows"]["histories"]
    assert mine["analysis"] == "shapes"
    assert mine["formulation"] == "closure_square_ref"
    assert mine["memory"] is None        # no allocator stats on the CPU
    assert mine["peak"]["source"].startswith("fallback")


def test_cost_is_the_shape_formula_of_the_rounds_read(monkeypatch):
    """cost = the mean per dispatch of 2·B·T³ per active round and
    (4·B·T² + B) bytes per launch, from the bucket log's rounds."""
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    es = encs(n=6, T=60, g1c_every=3) + encs(n=3, T=200)
    log: list = []
    cpu_sweep(es, budget_cells=1 << 17, bucket_log=log)
    recs = device_obs.records()
    assert len(log) > 1
    by_geom: dict = {}
    for b in log:
        B, T = b["histories"], b["t_pad"]
        ops = 2 * B * T ** 3 * sum(b["closure_rounds"])
        nbytes = (4 * B * T * T + B) * b["launches"]
        acc = by_geom.setdefault((B, T), [0, 0, 0])
        acc[0] += 1
        acc[1] += ops
        acc[2] += nbytes
    assert len(recs) == len(by_geom)
    for r in recs:
        g, w = r["geometry"], r["windows"]
        n, ops, nbytes = by_geom[(g["B"], g["n_txns"])]
        assert w["dispatches"] == n
        assert r["cost"]["flops"] == pytest.approx(ops / n, rel=1e-12)
        assert r["cost"]["bytes_accessed"] == pytest.approx(nbytes / n,
                                                            rel=1e-12)
        assert r["cost"]["transcendentals"] is None


def test_capture_dedups_per_geometry(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    es = encs()
    cpu_sweep(es)
    cpu_sweep(es)
    (rec,) = device_obs.records()
    assert rec["windows"]["dispatches"] == 2
    assert rec["windows"]["histories"] == 2 * len(es)
    assert 0 < rec["windows"]["min_secs"] <= rec["windows"]["max_secs"]


def test_cost_records_counter_ticks_once_per_record(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    tr = trace.fresh_run("c")
    es = encs()
    cpu_sweep(es)
    cpu_sweep(es)
    assert tr.metrics_dict()["counters"]["cost_records"] == 1


def test_gate_off_captures_nothing_and_opens_no_window(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("observed with the gate off")
    monkeypatch.setattr(device_obs, "observe", boom)
    cpu_sweep(encs())
    assert device_obs.records() == []
    assert device_obs._pending == {}


def test_verdicts_identical_gate_on_vs_off(monkeypatch):
    es = encs(n=6, g1c_every=2)
    off = cpu_sweep(es)
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    assert cpu_sweep(es) == off
    assert any(off)


def test_residency_gauges_published(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    tr = trace.fresh_run("g")
    cpu_sweep(encs())
    g = tr.metrics_dict()["gauges"]
    assert g["resident_executables"] == _build.resident_count() == 0
    assert g["hbm_modeled_bytes"] == 0      # nothing left in flight
    assert "hbm_device_bytes" not in g      # no allocator on the CPU


def test_health_snapshot_carries_the_device_section(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    tr = trace.fresh_run("h")
    cpu_sweep(encs())
    dev = health.health_snapshot(tr)["device"]
    assert dev == {"resident_executables": 0, "hbm_modeled_bytes": 0,
                   "hbm_device_bytes": None, "donated_bytes": None}


def test_pending_windows_are_keyed_by_the_dispatch(monkeypatch):
    """Two dispatches in flight whose flags tensors share an id (a freed
    tensor's id reused) keep two windows."""
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")

    class Part:
        def __init__(self):
            self.flags = torch.zeros(2, dtype=torch.int32)
            self.rounds = []
            self.t_pad = 128
            self.t_disp = 0.0
            self.done = None

    a, b = Part(), Part()
    b.flags = a.flags                        # one id for both
    win = device_obs.Window(("k", 2), 16, None, None)
    device_obs.begin_dispatch(a, win)
    device_obs.begin_dispatch(b, win)
    assert len(device_obs._pending) == 2
    device_obs.discard_dispatch(a)
    assert list(device_obs._pending) == [b]
    device_obs.discard_dispatch(b)
    assert device_obs._inflight_bytes == 0


def test_windows_from_many_threads_lose_no_update(monkeypatch):
    """Threads opening and closing windows of one record at once (more
    threads than cores, a short switch interval): every dispatch and
    history counted, nothing left in flight."""
    import sys
    import threading
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    batch = {"appends": torch.zeros(2, 8, 3, dtype=torch.int64),
             "reads": torch.zeros(2, 8, 3, dtype=torch.int64),
             "shape": K.BatchShape(n_txns=128, n_appends=8, n_reads=8,
                                   n_keys=8, max_pos=8)}
    kw = dict(classify=True, realtime=False, process_order=False,
              fused=True, square=None)

    class Part:
        def __init__(self):
            self.flags = torch.zeros(2, dtype=torch.int32)
            self.rounds = [torch.tensor(3, dtype=torch.int32)]
            self.t_pad = 128
            self.t_disp = 0.0
            self.done = None

    n_threads, per = 2 * (os.cpu_count() or 1) + 2, 50

    def work():
        for _ in range(per):
            part = Part()
            win = device_obs.open_window(kw, batch, False, CPU)
            device_obs.begin_dispatch(part, win)
            device_obs.close_dispatch(part, 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    (rec,) = device_obs.records()
    assert rec["windows"]["dispatches"] == n_threads * per
    assert rec["windows"]["histories"] == 2 * n_threads * per
    assert rec["cost"]["flops"] == 2 * 2 * 128 ** 3 * 3
    assert device_obs._pending == {} and device_obs._inflight_bytes == 0


def test_resident_count_counts_loaded_cuda_libraries(monkeypatch):
    monkeypatch.setattr(_build, "_loaded", {
        "closure_square": object(), "knossos_dense": object(),
        "wgl": object(), "hist_encode@/x.so": object()})
    assert _build.resident_count() == 2


# -- a CUDA error met by the observatory ends the sweep -----------------------

class _DeadEvent:
    def elapsed_time(self, _end):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


def _inject_dead_event(monkeypatch):
    real = device_obs.open_window

    def open_window(*a, **k):
        win = real(*a, **k)
        if win is not None:
            win.start = _DeadEvent()
        return win
    monkeypatch.setattr(device_obs, "open_window", open_window)


def test_guard_raises_what_must_end_the_sweep_and_logs_the_rest():
    with pytest.raises(RuntimeError, match="CUDA error"):
        with device_obs._guard("x"):
            raise RuntimeError("CUDA error: unspecified launch failure")
    with pytest.raises(_build.KernelLaunchError):
        with device_obs._guard("x"):
            raise _build.KernelLaunchError("launch failed")
    with device_obs._guard("x"):
        raise ValueError("a telemetry bug, not a device failure")


def test_cuda_error_in_the_observatory_raises_out_of_the_dispatch(
        monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    _inject_dead_event(monkeypatch)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cpu_sweep(encs())
    assert device_obs._pending == {}


def test_cuda_error_in_the_observatory_ends_the_cli_sweep(
        tmp_path, monkeypatch, capsys):
    """The supervisor's exit (255, no verdict written), not a debug log
    and a sweep that carries on."""
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    _inject_dead_event(monkeypatch)
    synth.write_synth_run_store(tmp_path / "s", B=3, T=40, K=4,
                                bad_every=0)
    rc = cli.main(["analyze-store", "--store", str(tmp_path / "s"),
                   "--device", "cpu"])
    capsys.readouterr()
    assert rc == 255
    assert not list((tmp_path / "s").rglob("results.json"))


# -- the costdb file ----------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [
    (port_store, port_store), (port_store, ref_store),
    (ref_store, port_store)], ids=["port-port", "port-ref", "ref-port"])
def test_append_and_load_roundtrip_across_packages(writer, reader,
                                                   tmp_path):
    p = tmp_path / "costdb.jsonl"
    recs = [{"v": 1, "geometry": {"B": 1}, "i": i} for i in range(3)]
    assert writer.append_costdb(p, recs) == 3
    with open(p, "a") as f:          # a crash mid-append: no newline
        f.write('{"v": 1, "geometry": {"B": 3}, "torn')
    got = reader.load_costdb(p)
    assert [r["i"] for r in got] == [0, 1, 2]
    assert got.exists and got.path == p and not got.empty
    assert list(reader.load_costdb(tmp_path)) == list(got)   # a store dir


def test_append_seals_a_torn_tail_first(tmp_path):
    p = tmp_path / "costdb.jsonl"
    p.write_text('{"v": 1, "geometry": {}, "torn": tru')
    port_store.append_costdb(p, [{"v": 1, "geometry": {"B": 1},
                                  "fresh": True}])
    loaded = port_store.load_costdb(p)
    assert len(loaded) == 1 and loaded[0]["fresh"] is True


def test_non_record_lines_skipped(tmp_path):
    p = tmp_path / "costdb.jsonl"
    p.write_text('null\n[]\n{"no_geometry": 1}\n'
                 '{"v": 1, "geometry": {"B": 1}}\n')
    assert len(port_store.load_costdb(p)) == 1


def test_missing_costdb_is_an_empty_typed_table(tmp_path):
    t = port_store.load_costdb(tmp_path / "nope.jsonl")
    assert t.empty and not t.exists and list(t) == []


def test_paths_are_the_reference_s(tmp_path, monkeypatch):
    for shard in (None, 0, 3):
        assert port_store.costdb_path(tmp_path, shard) == \
            ref_store.costdb_path(tmp_path, shard)
    assert port_store.plan_path(tmp_path) == ref_store.plan_path(tmp_path)
    monkeypatch.setenv("JEPSEN_TPU_PLANNER_PATH", str(tmp_path / "p.json"))
    assert port_store.plan_path(tmp_path) == tmp_path / "p.json" == \
        ref_store.plan_path(tmp_path)


def test_flush_gate_off_writes_no_file(tmp_path):
    assert device_obs.flush(tmp_path / "costdb.jsonl") == 0
    assert not (tmp_path / "costdb.jsonl").exists()


def test_killed_writer_leaves_a_torn_tail_the_next_append_seals(tmp_path):
    p = tmp_path / "costdb.jsonl"
    child = f"""
import os, signal, sys
sys.path.insert(0, {str(REPO)!r})
from jepsen_tpu_torch import store
p = {str(p)!r}
store.append_costdb(p, [{{"v": 1, "geometry": {{"B": i}}, "i": i}}
                        for i in range(3)])
with open(p, "a") as f:
    f.write('{{"v": 1, "geometry": {{"B": 9}}, "to')
    f.flush()
    os.kill(os.getpid(), signal.SIGKILL)
"""
    res = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         timeout=120)
    assert res.returncode == -signal.SIGKILL, res.stderr.decode()
    assert [r["i"] for r in port_store.load_costdb(p)] == [0, 1, 2]
    assert port_store.append_costdb(
        p, [{"v": 1, "geometry": {"B": 4}, "i": 3}]) == 1
    assert [r["i"] for r in port_store.load_costdb(p)] == [0, 1, 2, 3]


def test_short_write_is_best_effort(tmp_path, monkeypatch):
    """A write that fails part-way (a full disk) lands its prefix and
    raises EIO: the append returns the records that landed and never
    raises; the next append seals the torn tail."""
    p = tmp_path / "costdb.jsonl"
    recs = [{"v": 1, "geometry": {"B": i}, "i": i} for i in range(3)]
    line0 = json.dumps(recs[0]) + "\n"
    budget = [len(line0) + 11]
    real_open = open

    class Faulty:
        def __init__(self, f):
            self.f = f

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

        def write(self, s):
            if len(s) > budget[0]:
                self.f.write(s[:budget[0]])
                self.f.flush()
                budget[0] = 0
                raise OSError(5, "injected EIO")
            budget[0] -= len(s)
            return self.f.write(s)

        def __getattr__(self, name):
            return getattr(self.f, name)

    def faulty_open(path, mode="r", *a, **k):
        f = real_open(path, mode, *a, **k)
        return Faulty(f) if "a" in mode else f

    monkeypatch.setattr("builtins.open", faulty_open)
    n = port_store.append_costdb(p, recs)
    monkeypatch.setattr("builtins.open", real_open)
    assert n == 1
    raw = p.read_text()
    assert raw.startswith(line0) and not raw.endswith("\n")
    assert [r["i"] for r in port_store.load_costdb(p)] == [0]
    assert port_store.append_costdb(p, recs[1:]) == 2
    assert [r["i"] for r in port_store.load_costdb(p)] == [0, 1, 2]


# -- merge, bandwidth share and the report's device section -------------------

def _rec(B=8, dispatches=2, secs=0.5, provenance="estimated", flops=1e9,
         memory=None):
    return {
        "v": 1,
        "kernel": {"classify": True, "realtime": False,
                   "process_order": False, "fused": True},
        "formulation": "cuda-int8", "donated": False,
        "geometry": {"B": B, "n_txns": 128, "n_keys": 8,
                     "max_pos": 8, "n_appends": 64, "n_reads": 64},
        "backend": "cuda", "device_kind": H100, "analysis": "shapes",
        "cost": {"flops": flops, "bytes_accessed": 2e8,
                 "transcendentals": None},
        "memory": memory, "argument_bytes_actual": 1024,
        "windows": {"dispatches": dispatches, "device_secs": secs,
                    "min_secs": 0.1, "max_secs": 0.4,
                    "histories": B * dispatches},
        "peak": K.device_peak(H100), "provenance": provenance,
        "achieved": {"flops_per_sec": None, "bytes_per_sec": None},
        "roofline": {"flops_utilization": None,
                     "bandwidth_utilization": None},
    }


SHARDS = {
    "dedup": [[_rec(dispatches=2, secs=0.5), _rec(B=16, dispatches=1,
                                                  secs=0.2)],
              [_rec(dispatches=3, secs=1.0)]],
    "provenance": [[_rec(provenance="measured")],
                   [_rec(provenance="estimated")]],
    "memory": [[_rec()], [_rec(memory={"argument_bytes": 1,
                                       "output_bytes": 2,
                                       "temp_bytes": 3,
                                       "alias_bytes": None,
                                       "generated_code_bytes": None})]],
    "empty": [[], None, [_rec(B=4)]],
}


@pytest.mark.parametrize("case", sorted(SHARDS))
def test_merge_records_is_the_reference_s(case):
    lists = SHARDS[case]
    mine = device_obs.merge_records(lists)
    ref = ref_device.merge_records(lists)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        # the re-derivation reads each package's own peak table; the
        # card's row is in the port's alone
        assert a["peak"] == K.device_peak(H100)
        assert {k: v for k, v in a.items() if k not in ("peak", "roofline")} \
            == {k: v for k, v in b.items() if k not in ("peak", "roofline")}


def test_merge_sums_windows_and_rederives_rates():
    merged = device_obs.merge_records(SHARDS["dedup"])
    m = next(r for r in merged if r["geometry"]["B"] == 8)
    w = m["windows"]
    assert (w["dispatches"], w["histories"]) == (5, 40)
    assert w["device_secs"] == pytest.approx(1.5)
    assert m["achieved"]["flops_per_sec"] == pytest.approx(5 * 1e9 / 1.5)
    assert m["roofline"]["flops_utilization"] == pytest.approx(
        5 * 1e9 / 1.5 / 1979e12, abs=1e-6)
    assert m["provenance"] == "measured"     # windows taken on a card


def finalized():
    return device_obs.merge_records([[_rec(dispatches=4, secs=2.0)],
                                     [_rec(B=32, dispatches=1, secs=0.5,
                                           provenance="measured")]])


def test_bandwidth_share_is_the_reference_s():
    recs = finalized()
    assert device_obs.bandwidth_share(recs) == \
        ref_device.bandwidth_share(recs)
    bw = device_obs.bandwidth_share(recs)
    assert bw["provenance"] == "measured" and bw["peak_hbm_gbps"] == 3350.0
    assert device_obs.bandwidth_share([]) is None


def test_device_section_is_the_reference_s():
    recs = finalized()
    assert attribution.device_section(recs) == ref_attr.device_section(recs)
    dev = attribution.device_section(recs)
    md = "\n".join(attribution.render_device_md(dev))
    assert md == "\n".join(ref_attr.render_device_md(dev))
    assert "Device roofline" in md and "B8xT128" in md and H100 in md
    assert attribution.device_section([]) is None


def test_report_without_records_has_no_device_section(tmp_path):
    rj, _ = attribution.write_report(tmp_path, [], device_records=None)
    assert "device" not in json.loads(Path(rj).read_text())


# -- whole sweeps, both CLIs on one path in turn ------------------------------

@pytest.fixture
def cost_env(reference_env, monkeypatch):  # noqa: F811
    import jax
    mesh = ref_parallel.make_mesh(jax.devices()[:1])
    monkeypatch.setattr(ref_parallel, "make_mesh", lambda *a, **k: mesh)
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    monkeypatch.setenv("JEPSEN_TPU_DONATE_BUFFERS", "0")


def append_store(base):
    synth.write_synth_run_store(base, B=6, T=120, K=8, bad_every=3)


def wr_store(base):
    synth.write_wr_run_store(base, B=4, T=60, K=4, bad_every=2)


SWEEP_FILES = ("costdb.jsonl", "report.json")


def sweep_both(tmp_path, pristine, argv, capsys) -> tuple:
    grabbed = []

    def grab(store):
        grabbed.append({f: (store / f).read_bytes() for f in SWEEP_FILES
                        if (store / f).exists()})
    got = in_turn(tmp_path, pristine, [(argv, None), grab], capsys)
    return got, dict(zip(("ref", "port"), grabbed))


COMPARED = ("kernel", "geometry", "donated", "provenance")


@pytest.mark.parametrize("kind", ["append", "wr"])
def test_sweep_costdb_matches_the_reference(kind, tmp_path, cost_env,
                                            monkeypatch, capsys):
    pristine = tmp_path / "pristine"
    {"append": append_store, "wr": wr_store}[kind](pristine)
    argv = ["--checker", kind, "--report"]
    off, _ = sweep_both(tmp_path / "off", pristine, argv, capsys)
    # all four gates on: the costdb, health.json, /metrics, the planner
    for k, v in (("JEPSEN_TPU_COSTDB", "1"),
                 ("JEPSEN_TPU_HEALTH_INTERVAL_S", "0.2"),
                 ("JEPSEN_TPU_METRICS_PORT", "0"),
                 ("JEPSEN_TPU_PLANNER", "1")):
        monkeypatch.setenv(k, v)
    on, files = sweep_both(tmp_path / "on", pristine, argv, capsys)
    for pkg in ("ref", "port"):
        # verdicts.jsonl and every results file byte-identical gates on
        # and off, and equal across the packages
        assert on[pkg][:2] == off[pkg][:2] == on["ref"][:2]
    if kind == "wr":
        assert "costdb.jsonl" not in files["ref"]
        assert "costdb.jsonl" not in files["port"]
        for pkg in ("ref", "port"):
            assert "device" not in json.loads(files[pkg]["report.json"])
        return
    recs = {pkg: [json.loads(ln) for ln in
                  files[pkg]["costdb.jsonl"].decode().splitlines()]
            for pkg in ("ref", "port")}
    assert len(recs["ref"]) == len(recs["port"]) >= 1
    for r, p in zip(recs["ref"], recs["port"]):
        for k in COMPARED:
            assert r[k] == p[k], k
        for k in ("dispatches", "histories"):
            assert r["windows"][k] == p["windows"][k], k
        assert p["provenance"] == "estimated"
        assert list(p) == list(r)
    # each package's loader reads the other's file alike
    for pkg, other in (("ref", "port"), ("port", "ref")):
        p = tmp_path / f"{pkg}.jsonl"
        p.write_bytes(files[pkg]["costdb.jsonl"])
        mod = port_store if other == "port" else ref_store
        assert list(mod.load_costdb(p)) == recs[pkg]
    rep = json.loads(files["port"]["report.json"])
    dev = rep["device"]
    assert dev["provenance"] == "estimated"
    assert [(row["geometry"], row["dispatches"]) for row in dev["records"]] \
        == [(row["geometry"], row["dispatches"])
            for row in json.loads(files["ref"]["report.json"])["device"][
                "records"]]
    assert all(row["flops"] > 0 and row["device_secs"] > 0
               for row in dev["records"])


def test_search_section_gains_the_cost_join(tmp_path, cost_env, monkeypatch,
                                            capsys):
    """With the stats gate and the costdb both on, the report's search
    section joins device seconds per history by geometry, in both."""
    pristine = tmp_path / "pristine"
    append_store(pristine)
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    monkeypatch.setenv("JEPSEN_TPU_KERNEL_STATS", "1")
    _, files = sweep_both(tmp_path, pristine, ["--checker", "append",
                                               "--report"], capsys)
    geo = {pkg: json.loads(files[pkg]["report.json"])["search"]["by_geometry"]
           for pkg in ("ref", "port")}
    assert [r["t_pad"] for r in geo["ref"]] == \
        [r["t_pad"] for r in geo["port"]]
    for r, p in zip(geo["ref"], geo["port"]):
        assert p["device_secs_per_history"] is not None
        assert r["device_secs_per_history"] is not None
        assert {k: v for k, v in r.items()
                if k != "device_secs_per_history"} == \
            {k: v for k, v in p.items() if k != "device_secs_per_history"}


def test_gate_off_sweep_writes_no_costdb(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    append_store(tmp_path / "s")
    rc = cli.main(["analyze-store", "--store", str(tmp_path / "s"),
                   "--device", "cpu", "--report"])
    capsys.readouterr()
    assert rc == 1
    assert not list((tmp_path / "s").glob("costdb*.jsonl"))
    assert "device" not in json.loads(
        (tmp_path / "s" / "report.json").read_text())
    kinds = {json.loads(ln)["event"] for ln in
             (tmp_path / "s" / "events.jsonl").read_text().splitlines()}
    assert "costdb_flush" not in kinds


def test_gate_on_sweep_flushes_with_its_event(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    # --no-trace exports JEPSEN_TPU_TRACE=0; the teardown restores it
    monkeypatch.setenv("JEPSEN_TPU_TRACE", "1")
    append_store(tmp_path / "s")
    rc = cli.main(["analyze-store", "--store", str(tmp_path / "s"),
                   "--device", "cpu", "--no-trace"])
    err = capsys.readouterr().err
    assert rc == 1
    recs = port_store.load_costdb(tmp_path / "s")
    assert recs and f"costdb: {len(recs)} record(s) appended" in err
    ev = [json.loads(ln) for ln in
          (tmp_path / "s" / "events.jsonl").read_text().splitlines()]
    flush = [e for e in ev if e["event"] == "costdb_flush"]
    assert len(flush) == 1 and flush[0]["records"] == len(recs)

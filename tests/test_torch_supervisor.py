"""The port's supervised dispatch (jepsen_tpu_torch.supervisor, gates,
parallel.check_bucketed_async, cli) against the reference's
(tests/test_supervisor.py's scenarios), on the CPU.

Every recovery layer is driven through the self-nemesis
(JEPSEN_TPU_FAULT_INJECT) or a wedged device wait, in both packages
where the reference has the counterpart: injected encode faults
quarantine at once, injected OOMs split buckets down to singletons, a
wedged wait quarantines after one retry, a wr chunk backs down to single
histories, a pack failure quarantines only its bucket, and
JEPSEN_TPU_STRICT=1 restores fail-fast. What must end a sweep (an
interrupt, a kernel build or launch error, a missing device, a CUDA
error) is never quarantined. The device-side closure loop gives the
reference's flags and round counts.

The reference CLI and sweep run in this process with
`JEPSEN_TPU_AOT_CACHE=0`, a private `JEPSEN_TPU_COMPILE_CACHE_DIR` and
serial ingest (a one-core `os.cpu_count`; tests/test_torch_cli.py's
`reference_env`). The reference tests' counter assertions
(`quarantined`, `oom_retries`, `bucket_splits`, `watchdog_timeouts`)
wait for the port's tracer; the port's call sites are marked with the
counter each will feed.

Tolerance: exact. Equal flags, verdict dicts and bytes, round counts,
exit codes and journal lines."""

import functools
import json
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jepsen_tpu.cli as ref_cli
import jepsen_tpu.gates as ref_gates
import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu.supervisor as ref_sv
from jepsen_tpu.checker.elle import kernels as RK
from jepsen_tpu.checker.elle.encode import encode_history as ref_encode
from jepsen_tpu_torch import _build, cli, convert, gates, ingest, parallel
from jepsen_tpu_torch import supervisor as sv
from jepsen_tpu_torch.checker.elle import closure_square as cs
from jepsen_tpu_torch.checker.elle import kernels as K
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.elle.encode import encode_history
from jepsen_tpu_torch.devices import DeviceUnavailable
from jepsen_tpu_torch.store import Store
from test_torch_cli import reference_env  # noqa: F401
from test_torch_kernels import NAMES, _batch
from test_torch_stored import assert_same, in_turn

CPU = torch.device("cpu")
GATE_NAMES = ("JEPSEN_TPU_FAULT_INJECT", "JEPSEN_TPU_STRICT",
              "JEPSEN_TPU_DISPATCH_TIMEOUT_S", "JEPSEN_TPU_PACK_THREAD",
              "JEPSEN_TPU_FUSED_CLASSIFY")


@pytest.fixture(autouse=True)
def _clean_injection(monkeypatch, tmp_path):
    """Every test starts and ends with both nemeses disarmed, and the
    reference's executable cache private to the test."""
    for name in GATE_NAMES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path / "aot"))
    sv.reset_injection()
    ref_sv.reset_injection()
    yield
    sv.reset_injection()
    ref_sv.reset_injection()


def arm(monkeypatch, spec: str) -> None:
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", spec)
    sv.reset_injection()
    ref_sv.reset_injection()


def write_run(base: Path, name: str, hist: list) -> Path:
    d = base / name
    d.mkdir(parents=True)
    with open(d / "history.jsonl", "w") as f:
        for o in hist:
            f.write(json.dumps(o) + "\n")
    return d


def synth_store(base: Path, n: int = 8, T: int = 30,
                bad_every: int = 0) -> list[Path]:
    """The reference tests' store: n list-append runs under `etcd`, named
    as the reference's own runs are (`2020010<i>T000000`)."""
    return [write_run(base / "etcd", f"2020010{i}T000000",
                      synth.synth_append_history(
                          T=T, K=6, seed=i,
                          g1c=bool(bad_every and i % bad_every == 0)))
            for i in range(n)]


def wr_store(base: Path, n: int = 6, bad_every: int = 3) -> list[Path]:
    """n rw-register runs (`synth.write_wr_run_store`), renamed as
    synth_store's runs are, so the encode nemesis picks the same ones."""
    synth.write_wr_run_store(base, B=n, T=60, K=4, bad_every=bad_every,
                             name="etcd")
    dirs = []
    for i in range(n):
        d = base / "etcd" / f"2020010{i}T000000"
        (base / "etcd" / f"run-{i:05d}").rename(d)
        dirs.append(d)
    return dirs


def encode_selected(dirs, rate) -> set:
    """The run dirs the encode:<rate> nemesis picks (same hash in both
    packages)."""
    inj = sv._Injector(f"encode:{rate}")
    return {d.name for d in dirs if inj.selects("encode", d.name)}


def rearm(_store) -> None:
    """A step of `in_turn`: each package's sweep starts with fresh
    count-mode charges."""
    sv.reset_injection()
    ref_sv.reset_injection()


def encs_for(n: int = 6, T: int = 30):
    hists = [synth.synth_append_history(T=T, K=6, seed=i, g1c=i == 1)
             for i in range(n)]
    return [encode_history(h) for h in hists], \
        [ref_encode(h) for h in hists]


# -- gates and the injector ------------------------------------------------

RAWS = [None, "", "0", "1", "yes", "false", " 2.5 ", "abc", "-1", "0.0",
        "encode:0.4,oom:first", "  "]


@pytest.mark.parametrize("name", GATE_NAMES)
def test_gate_parse_rules_match_reference(name):
    mine, ref = gates.GATES[name], ref_gates.GATES[name]
    assert (mine.kind, mine.default) == (ref.kind, ref.default)
    for raw in RAWS:
        assert mine.parse(raw) == ref.parse(raw), raw


def test_gate_accessors_read_the_environment(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_DISPATCH_TIMEOUT_S", "bogus")
    assert gates.get("JEPSEN_TPU_DISPATCH_TIMEOUT_S") is None
    assert sv.dispatch_timeout_s() is None
    monkeypatch.setenv("JEPSEN_TPU_DISPATCH_TIMEOUT_S", "-1")
    assert sv.dispatch_timeout_s() is None
    assert gates.get_raw("JEPSEN_TPU_DISPATCH_TIMEOUT_S") == "-1"
    assert gates.is_set("JEPSEN_TPU_DISPATCH_TIMEOUT_S")
    assert not gates.is_set("JEPSEN_TPU_STRICT")
    assert gates.get("JEPSEN_TPU_PACK_THREAD") is True
    monkeypatch.setenv("JEPSEN_TPU_STRICT", "yes")
    assert sv.strict_enabled()
    with pytest.raises(KeyError):
        gates.get("JEPSEN_TPU_NOT_A_GATE")


@pytest.mark.parametrize("spec", ["encode:0.5,oom:first,kill:2",
                                  "encode:first", "encode:3,oom:2",
                                  "oom:999", "encode:1.0", "kill:0.25",
                                  "bogus,encode:x,:1,oom"])
def test_injector_spec_parsing_and_determinism(spec):
    """Same modes as the reference's injector for the same spec; rate
    modes are a pure function of the name, count modes burn charges."""
    mine, ref = sv._Injector(spec), ref_sv._Injector(spec)
    assert mine.modes == ref.modes
    for mode in ("encode", "oom", "kill"):
        for n in ("r0", "r1", "20200101T000000", "run-00004", None):
            assert mine.selects(mode, n) == ref.selects(mode, n), (mode, n)
    inj = sv._Injector("encode:0.5,oom:first,kill:2")
    assert inj.modes == {"encode": ("rate", 0.5), "oom": ("count", 1),
                         "kill": ("count", 2)}
    assert inj.selects("oom") is True and inj.selects("oom") is False
    assert inj.selects("kill") and inj.selects("kill")
    assert inj.selects("kill") is False


def test_encode_fault_raises_in_parent(monkeypatch, tmp_path):
    d = write_run(tmp_path, "r0", synth.synth_append_history(T=10, K=3,
                                                             seed=0))
    arm(monkeypatch, "encode:1.0")
    with pytest.raises(sv.InjectedFault, match="injected encode fault"):
        ingest.encode_run_dir(d)
    # kill mode degrades to a raise: the port has no pool worker
    arm(monkeypatch, "kill:first")
    with pytest.raises(sv.InjectedFault, match="worker kill"):
        ingest.encode_run_dir(d)
    assert ingest.encode_run_dir(d).n == 10     # one charge, spent
    # the chunked ingest reports the fault in the run's place
    arm(monkeypatch, "encode:1.0")
    (got,), = ingest.iter_encode_chunks([d])
    assert got[0] == d and isinstance(got[1], sv.InjectedFault)


def test_oom_errors_are_recognised(monkeypatch):
    assert sv.is_oom_error(sv.InjectedOom("RESOURCE_EXHAUSTED: x"))
    assert sv.is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert sv.is_oom_error(ref_sv.InjectedOom("RESOURCE_EXHAUSTED: x"))
    assert not sv.is_oom_error(RuntimeError("CUDA error: misaligned"))
    sv.maybe_inject_oom()                  # disarmed: nothing happens
    arm(monkeypatch, "oom:2")
    for _ in range(2):
        with pytest.raises(sv.InjectedOom) as e:
            sv.maybe_inject_oom()
        assert sv.is_oom_error(e.value)
    sv.maybe_inject_oom()                  # both charges spent


@pytest.mark.parametrize("err,ends", [
    (KeyboardInterrupt(), True), (SystemExit(1), True),
    (_build.KernelBuildError("nvcc failed"), True),
    (_build.KernelLaunchError("closure_square launch failed"), True),
    (DeviceUnavailable("no card"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), False),
    (sv.InjectedOom("RESOURCE_EXHAUSTED"), False),
    (ValueError("poisoned history"), False),
    (sv.WatchdogTimeout("exceeded"), False)])
def test_must_end_sweep(err, ends):
    assert sv.must_end_sweep(err) is ends


# -- the CLI under the self-nemesis, against the reference -------------------

def test_encode_fault_sweep_quarantines_and_matches_reference(
        tmp_path, reference_env, monkeypatch, capsys):  # noqa: F811
    """The acceptance sweep: under encode:0.4,oom:first both CLIs exit 2
    with the same quarantined runs (stage encode, no stored-checker
    detour) and byte-identical results, markers and journal lines; the
    other runs are byte-identical to a fault-free sweep."""
    pristine = tmp_path / "pristine"
    dirs = synth_store(pristine, n=8, bad_every=3)
    expect_q = encode_selected(dirs, 0.4)
    assert expect_q and len(expect_q) < len(dirs)
    argv = ["--checker", "append"]
    clean = in_turn(tmp_path, pristine, [(argv, None)], capsys,
                    packages=("port",))["port"]
    assert clean[0] == [1]

    arm(monkeypatch, "encode:0.4,oom:first")
    got = in_turn(tmp_path, pristine, [rearm, (argv, None)], capsys)
    assert_same(got)
    rcs, snap, out = got["port"]
    assert rcs == [2]
    quarantined = set()
    for d in dirs:
        key = f"etcd/{d.name}/results.json"
        res = json.loads(snap[key])
        if res.get("quarantined"):
            assert res == {"valid?": "unknown", "error":
                           f"injected encode fault for {d.name!r}",
                           "quarantined": "encode", "checker": "append"}
            quarantined.add(d.name)
        else:
            assert snap[key] == clean[1][key]
    assert quarantined == expect_q
    lines = [json.loads(ln) for ln in snap["verdicts.jsonl"]]
    assert len(lines) == len(dirs)
    assert sum(1 for e in lines if e.get("quarantined")) == len(expect_q)


def test_wr_sweep_under_faults_matches_reference(
        tmp_path, reference_env, monkeypatch, capsys):  # noqa: F811
    pristine = tmp_path / "pristine"
    dirs = wr_store(pristine)
    expect_q = encode_selected(dirs, 0.4)
    arm(monkeypatch, "encode:0.4,oom:first")
    got = in_turn(tmp_path, pristine, [rearm, (["--checker", "wr"], None)],
                  capsys)
    assert_same(got)
    rcs, snap, _ = got["port"]
    quarantined = {k.split("/")[1] for k, v in snap.items()
                   if k.endswith("results.json")
                   and json.loads(v).get("quarantined") == "encode"}
    assert rcs == [2] and quarantined == expect_q
    assert any(json.loads(v)["valid?"] is False for k, v in snap.items()
               if k.endswith("results.json"))


def test_strict_restores_fail_fast(tmp_path, monkeypatch, capsys):
    dirs = synth_store(tmp_path / "store", n=4)
    arm(monkeypatch, "encode:1.0")
    monkeypatch.setenv("JEPSEN_TPU_STRICT", "1")
    with pytest.raises(sv.InjectedFault):
        cli.analyze_store(Store(tmp_path / "store"), checker="append",
                          device="cpu")
    assert not (dirs[0] / "results.json").exists()
    # through the entry point: a crash, exit 255
    assert cli.main(["analyze-store", "--store", str(tmp_path / "store"),
                     "--device", "cpu"]) == 255
    capsys.readouterr()


def test_corrupt_history_quarantines_like_the_reference(
        tmp_path, reference_env, capsys):  # noqa: F811
    """A torn history.jsonl degrades to `valid? unknown` (the stored
    checker fails too) while its siblings still verify."""
    pristine = tmp_path / "pristine"
    dirs = synth_store(pristine, n=3)
    (dirs[1] / "history.jsonl").write_text('{"type": "invoke", "proc')
    got = in_turn(tmp_path, pristine, [(["--checker", "append"], None)],
                  capsys)
    assert_same(got)
    rcs, snap, _ = got["port"]
    assert rcs == [2]
    res = json.loads(snap[f"etcd/{dirs[1].name}/results.json"])
    assert res["valid?"] == "unknown" and res["quarantined"] == "stored"
    for d in (dirs[0], dirs[2]):
        assert json.loads(snap[f"etcd/{d.name}/results.json"])["valid?"] \
            is True


# -- OOM backdown ----------------------------------------------------------

@pytest.mark.parametrize("pack_thread", ["0", "1"])
def test_oom_first_splits_and_matches(monkeypatch, pack_thread):
    monkeypatch.setenv("JEPSEN_TPU_PACK_THREAD", pack_thread)
    encs, refs = encs_for()
    base = parallel.check_bucketed(encs, CPU)
    assert base == ref_parallel.check_bucketed(refs, None)
    arm(monkeypatch, "oom:first")
    log: list = []
    got = parallel.check_bucketed(encs, CPU, bucket_log=log)
    assert got == base
    # the one planned bucket of 6 came back as its two halves of 3
    assert [b["histories"] for b in log] == [3, 3]
    assert got == ref_parallel.check_bucketed(refs, None)


def test_oom_always_quarantines_singletons(monkeypatch):
    encs, refs = encs_for(4)
    arm(monkeypatch, "oom:999")
    got = parallel.check_bucketed(encs, CPU)
    want = ref_parallel.check_bucketed(refs, None)
    assert all(isinstance(g, sv.Quarantined) and g.stage == "oom"
               for g in got)
    assert [g.verdict("append") for g in got] == \
        [w.verdict("append") for w in want]
    v = got[0].verdict("append")
    assert v["valid?"] == "unknown" and v["quarantined"] == "oom"


def test_oom_strict_reraises(monkeypatch):
    encs, _ = encs_for(3)
    arm(monkeypatch, "oom:first")
    monkeypatch.setenv("JEPSEN_TPU_STRICT", "1")
    with pytest.raises(sv.InjectedOom):
        parallel.check_bucketed(encs, CPU)


def test_real_oom_at_enqueue_backs_down(monkeypatch):
    """A torch OutOfMemoryError raised while a 2-history bucket enqueues
    splits it; the halves check and the verdicts match a clean run."""
    encs, _ = encs_for(4)
    base = parallel.check_bucketed(encs, CPU)
    real = K.check_batch_device

    def tight(batch, **kw):
        if batch["n_txns"].shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(batch, **kw)

    monkeypatch.setattr(K, "check_batch_device", tight)
    log: list = []
    assert parallel.check_bucketed(encs, CPU, bucket_log=log) == base
    assert [b["histories"] for b in log] == [1, 1, 1, 1]


# -- the watchdog ----------------------------------------------------------

def wedge(calls: list):
    """A device wait that never completes in time."""
    def wedged(done, timeout):
        calls.append(timeout)
        time.sleep(timeout or 0)
        return False
    return wedged


def ref_watchdog_finish(monkeypatch, n: int) -> list:
    """The reference's `_finish_part` on a wedged block_until_ready."""
    release = threading.Event()

    def wedged(_flags):
        release.wait(2.0)
        return np.zeros(n, np.int64)

    monkeypatch.setattr(ref_parallel.jax, "block_until_ready", wedged)
    kw = dict(classify=True, realtime=False, process_order=False,
              fused=None)
    try:
        return ref_parallel._finish_part(
            [], list(range(n)), np.zeros(n, np.int64), None, 1 << 20, kw,
            ref_parallel.trace.get_current(), None)
    finally:
        release.set()


def test_watchdog_retries_then_quarantines(monkeypatch):
    """A wedged wait burns both attempts, then the bucket quarantines
    (never hangs, never crashes), as the reference's does; without the
    gate the watchdog is off."""
    assert sv.dispatch_timeout_s() is None
    monkeypatch.setenv("JEPSEN_TPU_DISPATCH_TIMEOUT_S", "0.05")
    assert sv.dispatch_timeout_s() == 0.05
    calls: list = []
    monkeypatch.setattr(parallel, "_device_ready", wedge(calls))
    sw = parallel._Sweep([], CPU, {}, None)
    part = parallel._Dispatch(torch.zeros(2, dtype=torch.int32), [], None,
                              128, time.perf_counter())
    out = parallel._finish_part(sw, [0, 1], part, 1 << 20)
    assert calls == [0.05, 0.05]
    assert all(isinstance(w, sv.Quarantined) and w.stage == "watchdog"
               for w in out)
    want = ref_watchdog_finish(monkeypatch, 2)
    assert [w.verdict("append") for w in out] == \
        [w.verdict("append") for w in want]


def test_watchdog_strict_reraises(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_DISPATCH_TIMEOUT_S", "0.05")
    monkeypatch.setenv("JEPSEN_TPU_STRICT", "1")
    monkeypatch.setattr(parallel, "_device_ready", wedge([]))
    part = parallel._Dispatch(torch.zeros(1, dtype=torch.int32), [], None,
                              128, time.perf_counter())
    with pytest.raises(sv.WatchdogTimeout):
        parallel._finish_part(parallel._Sweep([], CPU, {}, None), [0],
                              part, 1 << 20)


def test_watchdog_off_waits_plainly(monkeypatch):
    """Without the gate the wait is unbounded: one call, no timeout."""
    calls: list = []
    real = parallel._device_ready

    def spy(done, timeout):
        calls.append(timeout)
        return real(done, timeout)

    monkeypatch.setattr(parallel, "_device_ready", spy)
    encs, _ = encs_for(2)
    assert parallel.check_bucketed(encs, CPU)[1] == {"G1c": True}
    assert calls == [None]


@pytest.mark.parametrize("checker", ["append", "wr"])
def test_sweep_on_a_wedged_device_matches_reference(
        checker, tmp_path, reference_env, monkeypatch, capsys):  # noqa: F811
    """Every device wait times out: the append sweep quarantines each
    bucket (stage watchdog); the wr chunk falls back to single
    histories, quarantines two and then the rest as a wedged device —
    byte-identical to the reference CLI."""
    pristine = tmp_path / "pristine"
    if checker == "append":
        synth_store(pristine, n=4)
    else:
        wr_store(pristine, n=4, bad_every=5)
    monkeypatch.setenv("JEPSEN_TPU_DISPATCH_TIMEOUT_S", "0.02")
    release = threading.Event()
    monkeypatch.setattr(ref_parallel.jax, "block_until_ready",
                        lambda flags: release.wait(5.0))
    monkeypatch.setattr(parallel, "_device_ready", wedge([]))
    try:
        got = in_turn(tmp_path, pristine, [(["--checker", checker], None)],
                      capsys)
    finally:
        release.set()
    assert_same(got)
    rcs, snap, _ = got["port"]
    assert rcs == [2]
    res = [json.loads(v) for k, v in sorted(snap.items())
           if k.endswith("results.json")]
    assert all(r["quarantined"] == "watchdog" for r in res)
    if checker == "wr":
        assert [r["error"].startswith("device wedged") for r in res] == \
            [False, False, True, True]


# -- the wr backdown ladder ------------------------------------------------

class FakeWr:
    @staticmethod
    def to_edge_dict(e):
        return e


class FlakyKernels:
    """The batch times out, and so does every history 0 alone."""

    def __init__(self):
        self.calls = 0

    def check_edge_batch_bucketed(self, edges, **kw):
        self.calls += 1
        if self.calls == 1 or edges[0]["i"] == 0:
            raise self.error("wedged dispatch")
        return [{"i": e["i"]} for e in edges]


class AlwaysWedged:
    def __init__(self):
        self.calls = 0

    def check_edge_batch_bucketed(self, edges, **kw):
        self.calls += 1
        raise self.error("wedged dispatch")


def _ladder(kernel_cls, err_mod, backdown, n):
    k = kernel_cls()
    k.error = err_mod.WatchdogTimeout
    out = backdown([(f"d{i}", {"i": i}) for i in range(n)], k, FakeWr)
    return k.calls, [(o.stage, o.error) if hasattr(o, "verdict") else o
                     for o in out]


@pytest.mark.parametrize("kernel_cls,n", [(FlakyKernels, 2),
                                          (AlwaysWedged, 6)])
def test_wr_backdown_matches_reference(kernel_cls, n):
    """A batch-level watchdog timeout degrades to singletons; a history
    whose singleton also times out quarantines; two consecutive
    singleton timeouts quarantine the rest without probing."""
    got = _ladder(kernel_cls, sv, cli._wr_chunk_with_backdown, n)
    want = _ladder(kernel_cls, ref_sv, ref_cli._wr_chunk_with_backdown, n)
    assert got == want
    calls, out = got
    assert out[0][0] == "watchdog"
    if kernel_cls is AlwaysWedged:
        assert calls == 3     # 1 batch probe + 2 singleton probes
        assert all(o[0] == "watchdog" for o in out)
    else:
        assert out[1] == {"i": 1}


def test_wr_backdown_oom_and_strict(monkeypatch):
    """An OOM takes the same ladder (stage oom); strict re-raises."""
    k = AlwaysWedged()
    k.error = sv.InjectedOom
    out = cli._wr_chunk_with_backdown([("d0", {"i": 0})], k, FakeWr)
    assert k.calls == 2 and out[0].stage == "oom"
    monkeypatch.setenv("JEPSEN_TPU_STRICT", "1")
    with pytest.raises(sv.InjectedOom):
        cli._wr_chunk_with_backdown([("d0", {"i": 0})], k, FakeWr)


# -- per-bucket isolation --------------------------------------------------

@pytest.mark.parametrize("budget", [128 * 128, 2 * 128 * 128],
                         ids=["oversized-alone", "pack-thread"])
def test_pack_failure_quarantines_only_its_bucket(monkeypatch, budget):
    """A history that breaks packing fails ALONE; the rest of the sweep
    still verdicts. At budget 128² every history is an oversized
    singleton (dispatched alone, last); at 2·128² each is its own
    bucket through the pack-h2d thread."""
    encs, _ = encs_for(4)
    base = parallel.check_bucketed(encs, CPU)
    poisoned = encs[2]
    orig = K.pack_batch

    def bad_pack(group, *a, **kw):
        if any(e is poisoned for e in group):
            raise ValueError("poisoned history")
        return orig(group, *a, **kw)

    monkeypatch.setattr(K, "pack_batch", bad_pack)
    got = parallel.check_bucketed(encs, CPU, budget_cells=budget)
    for i, (g, b) in enumerate(zip(got, base)):
        if i == 2:
            assert isinstance(g, sv.Quarantined) and g.stage == "pack"
            assert g.error == repr(ValueError("poisoned history"))
        else:
            assert g == b


@pytest.mark.parametrize("pack_thread", ["0", "1"])
def test_keyboard_interrupt_is_never_quarantined(monkeypatch, pack_thread):
    monkeypatch.setenv("JEPSEN_TPU_PACK_THREAD", pack_thread)
    encs, _ = encs_for(3)

    def interrupted(*a, **kw):
        raise KeyboardInterrupt

    monkeypatch.setattr(K, "pack_batch", interrupted)
    with pytest.raises(KeyboardInterrupt):
        parallel.check_bucketed(encs, CPU, budget_cells=2 * 128 * 128)


@pytest.mark.parametrize("pack_thread", ["0", "1"])
@pytest.mark.parametrize("err", [
    _build.KernelBuildError("nvcc failed building closure_square"),
    DeviceUnavailable("no CUDA device is available"),
    _build.KernelLaunchError("closure_square launch failed"),
    RuntimeError("CUDA error: an illegal memory access was encountered")],
    ids=["build", "device", "launch", "cuda"])
def test_device_failures_in_h2d_end_the_sweep(monkeypatch, err,
                                              pack_thread):
    """A copy that fails for the device's sake is no bucket's fault:
    it re-raises and ends the sweep instead of quarantining."""
    monkeypatch.setenv("JEPSEN_TPU_PACK_THREAD", pack_thread)
    encs, _ = encs_for(3)

    def failing(item, device, stream=None):
        raise err

    monkeypatch.setattr(parallel, "_h2d_bucket", failing)
    with pytest.raises(type(err)):
        parallel.check_bucketed(encs, CPU, budget_cells=2 * 128 * 128)


def test_build_error_through_the_cli_exits_255(tmp_path, monkeypatch,
                                               capsys):
    synth_store(tmp_path / "store", n=2)

    def failing(item, device, stream=None):
        raise _build.KernelBuildError("nvcc failed building closure_square")

    monkeypatch.setattr(parallel, "_h2d_bucket", failing)
    assert cli.main(["analyze-store", "--store", str(tmp_path / "store"),
                     "--device", "cpu"]) == 255
    assert not list((tmp_path / "store").rglob("results.json"))
    capsys.readouterr()


# -- the pipeline ----------------------------------------------------------

@pytest.mark.parametrize("pack_thread", ["0", "1"])
def test_async_plans_at_half_the_budget_and_matches(monkeypatch,
                                                    pack_thread):
    """max_inflight=2 plans each bucket at budget // 2; the oversized
    singleton goes last, alone; the verdicts equal a one-at-a-time run
    and the reference's."""
    monkeypatch.setenv("JEPSEN_TPU_PACK_THREAD", pack_thread)
    hists = [synth.synth_append_history(T=T, K=6, seed=i, g1c=i % 2 == 0)
             for i, T in enumerate([300, 100, 100, 100, 100, 90])]
    encs = [encode_history(h) for h in hists]
    budget = 2 * 3 * 128 * 128          # 3 T_pad=128 histories a slot
    log: list = []
    pv = parallel.check_bucketed_async(encs, CPU, budget_cells=budget,
                                       bucket_log=log)
    assert pv.is_ready()                 # the CPU has nothing in flight
    got = pv.result()
    assert pv.result() is got            # idempotent
    # longest first: [302], then [102, 102, 100] (two cyclic), then
    # [100, 90] (acyclic: its classification closures skipped on the
    # device), the 302-txn singleton over the per-slot budget last
    assert [(b["histories"], b["t_pad"], len(b["closure_rounds"]))
            for b in log] == [(3, 128, 3), (2, 128, 1), (1, 384, 3)]
    for b in log:
        assert b["launches"] == K.closure_steps(b["t_pad"]) * 3
    one = parallel.check_bucketed_async(encs, CPU, budget_cells=budget,
                                        max_inflight=1).result()
    assert got == one == ref_parallel.check_bucketed(
        [ref_encode(h) for h in hists], None, budget_cells=budget)


def test_dispatch_reads_nothing_back(monkeypatch):
    """Between enqueue and resolution the host reads no tensor: every
    read method raises while check_bucketed_async enqueues two buckets
    (max_inflight of them, so none is resolved early; pack thread off,
    so everything runs on this thread)."""
    monkeypatch.setenv("JEPSEN_TPU_PACK_THREAD", "0")
    encs, _ = encs_for(4)

    def no_read(*a, **kw):
        raise AssertionError("a host read during dispatch")

    with monkeypatch.context() as m:
        for meth in ("__bool__", "item", "tolist", "cpu", "numpy",
                     "__int__", "__index__"):
            m.setattr(torch.Tensor, meth, no_read)
        pv = parallel.check_bucketed_async(encs, CPU,
                                           budget_cells=4 * 128 * 128)
    assert len(pv._parts) == 2
    assert pv.result() == parallel.check_bucketed(encs, CPU)


# -- the closure loop on the device ----------------------------------------

def _ref_edges(batch):
    shape = batch["shape"]
    edges = jax.vmap(functools.partial(
        RK._edges_one, n_keys=shape.n_keys, max_pos=shape.max_pos,
        n_txns=shape.n_txns))
    return edges(jnp.asarray(batch["appends"]), jnp.asarray(batch["reads"]))


def _ref_rounds(batch, classify: bool, fused: bool) -> list[int]:
    """Each closure's round count as the reference's `_closure_batched`
    runs it, in the port's order of closures (no realtime or process
    edges)."""
    steps = RK.closure_steps(batch["shape"].n_txns)
    ww, wr, rw = _ref_edges(batch)

    def closure(m):
        c, i = RK._closure_batched(m, steps, RK._identity)
        return c, int(i)

    if not classify or fused:
        full = ww | wr | rw
        c_full, i0 = closure(full)
        if not classify:
            return [i0]
        T = full.shape[-1]
        cycle = jnp.any(full & jnp.swapaxes(c_full, 1, 2)
                        & ~jnp.eye(T, dtype=bool))
        if not bool(cycle):
            return [i0]
        c_ww, i1 = closure(ww)
        return [i0, i1, closure(c_ww | wr)[1]]
    c_ww, i1 = closure(ww)
    c_wwr, i2 = closure(c_ww | wr)
    return [i1, i2, closure(c_wwr | rw)[1]]


@pytest.mark.parametrize("name", ["valid", "g1c", "random"])
@pytest.mark.parametrize("classify,fused", [(False, True), (True, True),
                                            (True, False)],
                         ids=["detect", "fused", "two-pass"])
def test_device_loop_flags_and_rounds_match_reference(name, classify,
                                                      fused):
    """Flags equal the reference's check_batch_device; each closure's
    rounds equal the reference's while_loop counter (the fused path's
    classification closures, skipped on the device for an all-acyclic
    bucket, count as not run); the detect closure's count equals the
    reference's closure_rounds_device."""
    batch = _batch(name)
    shape = batch["shape"]
    steps = RK.closure_steps(shape.n_txns)
    kw = dict(classify=classify, fused=fused)
    want = np.asarray(RK.check_batch_device(
        *(jnp.asarray(batch[k]) for k in NAMES), n_keys=shape.n_keys,
        max_pos=shape.max_pos, n_txns=shape.n_txns, steps=steps,
        realtime=False, process_order=False, **kw))
    rounds: list = []
    got = K.check_batch_device(convert.from_reference_batch(batch, CPU),
                               rounds=rounds, **kw)
    assert (got.numpy() == want).all()
    counts = K.read_rounds(rounds)
    assert counts == _ref_rounds(batch, classify, fused)
    if not classify or fused:
        assert counts[0] == int(RK.closure_rounds_device(
            jnp.asarray(batch["appends"]), jnp.asarray(batch["reads"]),
            n_keys=shape.n_keys, max_pos=shape.max_pos,
            n_txns=shape.n_txns, steps=steps))
    if name == "valid" and classify and fused:
        assert len(rounds) == 3 and len(counts) == 1   # skipped on device


@pytest.mark.parametrize("T", [128, 384])
def test_inactive_round_returns_its_input(T):
    rng = np.random.default_rng(T)
    m = torch.from_numpy(rng.random((3, T, T)) < 0.02)
    mt = m.transpose(1, 2).contiguous()
    off = torch.tensor([0, 0], dtype=torch.int32)
    for fn in (cs.closure_square, cs.closure_square_ref):
        out, out_t, changed = fn(m, mt, off)
        assert torch.equal(out, m) and torch.equal(out_t, mt)
        assert not changed.any() and off.tolist() == [0, 0]
    on = torch.tensor([1, 0], dtype=torch.int32)
    for got, want in zip(cs.closure_square(m, mt, on),
                         cs.closure_square_ref(m, mt)):
        assert torch.equal(got, want)
    assert on.tolist() == [1, 1]           # it changed: next round runs
    closed = torch.eye(T, dtype=torch.bool)[None]
    on = torch.tensor([1, 0], dtype=torch.int32)
    cs.closure_square(closed, closed.clone(), on)
    assert on.tolist() == [1, 0]           # fixpoint: next round skipped
    with pytest.raises(ValueError):
        cs.closure_square(m, mt, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        cs.closure_square(m, mt, torch.zeros(2, dtype=torch.int64))

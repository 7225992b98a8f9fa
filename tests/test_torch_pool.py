"""The port's pooled ingest (jepsen_tpu_torch.ingest's process pool,
jepsen_tpu_torch.shm and the worker trace fabric) against the
reference's, on the CPU, at a small size with two spawned workers.

- Encodings: the pooled `iter_encode_chunks(processes=2)` delivers, in
  run order, what the reference's serial
  `jepsen_tpu.ingest.parallel_encode(processes=0)` encodes, array for
  array, for append and wr runs, with v1 and v2 sidecars, cold and
  warm, over each transport (shared memory, JEPSEN_TPU_SHM_INGEST=0,
  and an unusable /dev/shm).
- Failures: a worker's exception stays with its run; a pool that dies
  mid-stream leaves parse spans only of yielded items, resumes serially
  and unlinks the segments it never consumed (the reference test's
  stand-in executor); `kill:` SIGKILLs a real worker and the sweep
  resumes serially.
- `parallel_load` equals `load_runs`; the pool's three gates parse as
  the reference's.
- The port's CLI with the pool on gives the reference CLI's exit codes,
  results files, journal and summary lines for append, wr and register,
  also under `kill:`, and the same pool counters in metrics.json.

No test bounds a wall clock. Leak checks look only at the port's
segment prefix and this process's pid.

Tolerance: exact (arrays equal with their dtypes, files byte-equal)."""

import json
import os
import shutil
import signal

import pytest

import jepsen_tpu.gates as ref_gates
import jepsen_tpu.ingest as r_ingest
import jepsen_tpu.parallel as ref_parallel
from jepsen_tpu_torch import gates, ingest, shm, supervisor, trace
from jepsen_tpu_torch.checker.elle import synth
from test_torch_cli import reference_env  # noqa: F401
from test_torch_native_encode import same_append, same_wr
from test_torch_register import mixed_store as register_store
from test_torch_sidecar import sweep_store
from test_torch_stored import assert_same, in_turn

SAME = {"append": same_append, "wr": same_wr}
#: every env gate the pool's behaviour depends on
POOL_GATES = ("JEPSEN_TPU_ENCODE_CACHE", "JEPSEN_TPU_ENCODE_CACHE_WRITE",
              "JEPSEN_TPU_SIDECAR_V2", "JEPSEN_TPU_NATIVE_INGEST",
              "JEPSEN_TPU_NO_NATIVE", "JEPSEN_TPU_SHM_INGEST",
              "JEPSEN_TPU_PIPELINE", "JEPSEN_TPU_FAULT_INJECT",
              "JEPSEN_TPU_TRACE", "JEPSEN_TPU_WORKER_TRACE",
              "JEPSEN_TPU_STRICT")


def my_segments() -> list:
    """Port segments named for this process: the parent names every
    segment of its pool (`shm.gen_name`)."""
    pre = f"{shm.NAME_PREFIX}_{os.getpid()}_"
    try:
        return [x for x in os.listdir("/dev/shm") if x.startswith(pre)]
    except FileNotFoundError:
        return []


def spawn_anywhere(monkeypatch) -> None:
    """Let both packages' pools spawn where pytest-xdist runs the tests:
    an xdist worker's __main__ is code it was sent, with neither a file
    nor a module spec, so `_spawn_safe` (which wants one) says no —
    though spawn then re-imports no main module at all, and workers
    boot."""
    monkeypatch.setattr(ingest, "_spawn_safe", lambda: True)
    monkeypatch.setattr(r_ingest, "_spawn_safe", lambda: True)


@pytest.fixture(autouse=True)
def pool_env(monkeypatch):
    for g in POOL_GATES:
        monkeypatch.delenv(g, raising=False)
    monkeypatch.setattr(shm, "_probe", None)
    spawn_anywhere(monkeypatch)
    supervisor.reset_injection()
    trace.reset()
    yield monkeypatch
    supervisor.reset_injection()
    trace.reset()
    trace.close_worker_spool()
    assert not my_segments()


@pytest.mark.parametrize("name", ("JEPSEN_TPU_PIPELINE",
                                  "JEPSEN_TPU_SHM_INGEST",
                                  "JEPSEN_TPU_WORKER_TRACE"))
def test_gate_parse_rules_match_reference(name):
    mine, ref = gates.GATES[name], ref_gates.GATES[name]
    assert (mine.kind, mine.default) == (ref.kind, ref.default)
    for raw in (None, "", "0", "1", "yes", "false", " 2 ", "abc", "-1",
                "0.0", "  "):
        assert mine.parse(raw) == ref.parse(raw), raw


def runs(base, checker: str, n: int = 5) -> list:
    """n runs of `checker`'s shape, two lengths, some anomalous."""
    if checker == "append":
        return synth.write_synth_run_store(base, B=n, T=60, K=5,
                                           bad_every=2)
    return synth.write_wr_run_store(base, B=n, T=50, K=4, bad_every=2)


def reference_encodings(dirs, checker: str, tmp_path, mp) -> list:
    """The reference's serial encodings of a copy of `dirs`, cache off."""
    copy = tmp_path / "ref-copy"
    shutil.copytree(dirs[0].parent.parent, copy)
    with mp.context() as m:
        m.setenv("JEPSEN_TPU_ENCODE_CACHE", "0")
        return r_ingest.parallel_encode(
            [copy / d.parent.name / d.name for d in dirs], checker,
            processes=0)


def pooled(dirs, checker: str, **kw) -> tuple:
    info: dict = {}
    got = []
    for part in ingest.iter_encode_chunks(dirs, checker, chunk=2,
                                          processes=2, info=info, **kw):
        got.extend(part)
    return got, info


@pytest.mark.parametrize("transport", ["shm", "gate-off", "unavailable"])
@pytest.mark.parametrize("warmth", ["cold", "warm"])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("checker", ["append", "wr"])
def test_pooled_encodings_equal_reference_serial(checker, version, warmth,
                                                 transport, tmp_path,
                                                 pool_env):
    dirs = runs(tmp_path / "s", checker)
    want = reference_encodings(dirs, checker, tmp_path, pool_env)
    pool_env.setenv("JEPSEN_TPU_SIDECAR_V2", str(int(version == 2)))
    if warmth == "warm":
        for d in dirs:                 # the package's own sidecars
            ingest.encode_run_dir(d, checker)
    if transport == "gate-off":
        pool_env.setenv("JEPSEN_TPU_SHM_INGEST", "0")
    elif transport == "unavailable":
        pool_env.setattr(shm, "_probe", False)
    tr = trace.fresh_run("pool", scope="sweep")
    got, info = pooled(dirs, checker)
    assert info["pooled"] is True
    assert [d for d, _ in got] == dirs
    assert len(info["parse_spans"]) == len(dirs)
    for (_d, enc), ref in zip(got, want):
        assert not isinstance(enc, Exception), enc
        SAME[checker](enc, ref)
    c = tr.metrics_dict()["counters"]
    assert c["cache_hits" if warmth == "warm" else "cache_misses"] == 5
    # a v2 sidecar travels as a reference (wr writes v1 only); other
    # encodings ride shared memory unless it is off or unusable
    by_ref = version == 2 and checker == "append"
    assert ("shm_bytes" in c) == (not by_ref and transport == "shm")


def test_worker_exception_stays_with_its_run(tmp_path, pool_env):
    dirs = runs(tmp_path / "s", "append", n=6)
    (dirs[1] / "history.jsonl").write_text("{not json\n")
    inj = supervisor._Injector("encode:0.5")
    hit = [i for i, d in enumerate(dirs) if inj.selects("encode", d.name)]
    assert hit and 1 not in hit and len(hit) < 5
    pool_env.setenv("JEPSEN_TPU_FAULT_INJECT", "encode:0.5")
    pool_env.setenv("JEPSEN_TPU_NATIVE_INGEST", "0")
    got, info = pooled(dirs, "append")
    assert info["pooled"] and [d for d, _ in got] == dirs
    for i, (_d, enc) in enumerate(got):
        if i in hit:
            # the port's own class, so the CLI quarantines it
            assert type(enc) is supervisor.InjectedFault
        elif i == 1:
            assert isinstance(enc, Exception) \
                and not isinstance(enc, supervisor.InjectedFault)
        else:
            assert not isinstance(enc, Exception) and enc.n >= 60


def test_pool_failure_trims_spans_and_unlinks(tmp_path, pool_env):
    """A pool that dies mid-stream: parse spans only of yielded items,
    a serial resume without a dropped or doubled run, and every segment
    a worker created for an item the parent never consumed unlinked
    (tests/test_ingest_pipeline.py's stand-in executor)."""
    import concurrent.futures as cf
    dirs = runs(tmp_path / "s", "append", n=6)
    pool_env.setenv("JEPSEN_TPU_SIDECAR_V2", "0")
    encs = ingest.parallel_encode(dirs, processes=0)
    delivered = 3
    stale: list = []
    tasks: list = []

    class FakeFut:
        def __init__(self, k, task):
            self.k = k
            self.task = task

        def result(self):
            idx, _d, checker, name, _tctx = self.task
            if self.k >= delivered:
                raise RuntimeError("pool died mid-stream")
            if name is not None and self.k == delivered - 1:
                # a worker wrote the NEXT item's segment, then died
                nxt = tasks[self.k + 1][3]
                assert shm.is_descriptor(
                    shm.export(encs[tasks[self.k + 1][0]], nxt, checker))
                stale.append(nxt)
            payload = (shm.export(encs[idx], name, checker)
                       if name is not None else encs[idx])
            return idx, payload, {"cache": None}, 0.0, 0.0

    class FakeExecutor:
        def __init__(self, max_workers=None, mp_context=None):
            pass

        def submit(self, fn, task):
            tasks.append(task)
            return FakeFut(len(tasks) - 1, task)

        def shutdown(self, wait=True, cancel_futures=False):
            pass

    pool_env.setattr(cf, "ProcessPoolExecutor", FakeExecutor)
    pool_env.setattr(cf, "as_completed",
                     lambda fs: iter(sorted(fs, key=lambda f: f.k)))
    got, info = pooled(dirs, "append")
    assert [d for d, _ in got] == dirs
    for (_d, enc), ref in zip(got, encs):
        same_append(enc, ref)
    # three delivered before the pool died: one whole chunk of two
    # was yielded from the pool, so two spans
    assert len(info["parse_spans"]) == 2
    assert stale and not any(os.path.exists(f"/dev/shm/{n}")
                             for n in stale)


def recording_executor(pool_env, box: list):
    """ProcessPoolExecutor, keeping each instance's worker processes."""
    import concurrent.futures as cf
    real = cf.ProcessPoolExecutor

    class Recording(real):
        def submit(self, *a, **k):
            fut = super().submit(*a, **k)
            box.extend(p for p in self._processes.values()
                       if p not in box)
            return fut

    pool_env.setattr(cf, "ProcessPoolExecutor", Recording)


def killed_runs(dirs, spec: str) -> list:
    inj = supervisor._Injector(spec)
    return [i for i, d in enumerate(dirs) if inj.selects("kill", d.name)]


def test_kill_sigkills_a_worker_and_resumes_serially(tmp_path, pool_env,
                                                     caplog):
    # run-00009 alone is selected: a worker dies mid-stream
    dirs = runs(tmp_path / "s", "append", n=12)[1:]
    spec = "kill:0.5"
    hit = killed_runs(dirs, spec)
    assert hit == [8]
    pool_env.setenv("JEPSEN_TPU_FAULT_INJECT", spec)
    pool_env.setenv("JEPSEN_TPU_SIDECAR_V2", "0")   # the shm transport
    procs: list = []
    recording_executor(pool_env, procs)
    tr = trace.fresh_run("kill", scope="sweep")
    tr.spool_dir = tmp_path
    got, info = pooled(dirs, "append")
    assert info["pooled"] and [d for d, _ in got] == dirs
    for i, (_d, enc) in enumerate(got):
        if i in hit:
            # re-encoded in the parent, where kill degrades to a raise
            assert type(enc) is supervisor.InjectedFault
            assert "worker kill" in str(enc)
        else:
            assert not isinstance(enc, Exception) and enc.n >= 60
    assert -signal.SIGKILL in [p.exitcode for p in procs]
    assert "pipelined encode pool failed" in caplog.text
    # the killed worker flushed its fault mark to its spool first
    marks = [e for p in trace.iter_spools(tmp_path)
             for e in trace.load_spool(p)[2]
             if e["name"] == "fault_inject"]
    assert marks and marks[0]["args"]["kind"] == "kill"


def test_parallel_load_equals_load_runs(tmp_path):
    dirs = runs(tmp_path / "s", "append", n=5)
    (dirs[2] / "history.jsonl").write_text("[1, 2\n")
    serial = ingest.load_runs(dirs)
    got = ingest.parallel_load(dirs, processes=2)
    assert len(got) == len(serial) == 5
    for a, b in zip(got, serial):
        if isinstance(b, Exception):
            assert type(a) is type(b) and str(a) == str(b)
        else:
            assert a == b


def test_serial_paths_spawn_nothing(tmp_path, pool_env):
    """processes=0, one run, or one core without JEPSEN_TPU_PIPELINE:
    no pool; with the gate, one core still pools."""
    dirs = runs(tmp_path / "s", "append", n=3)
    for kw, n in (({"processes": 0}, 3), ({}, 1)):
        info: dict = {}
        got = [x for part in ingest.iter_encode_chunks(
            dirs[:n], info=info, **kw) for x in part]
        assert len(got) == n and info["pooled"] is False
    pool_env.setattr(os, "cpu_count", lambda: 1)
    info = {}
    list(ingest.iter_encode_chunks(dirs, info=info))
    assert info["pooled"] is False
    pool_env.setenv("JEPSEN_TPU_PIPELINE", "1")
    list(ingest.iter_encode_chunks(dirs, info=info))
    assert info["pooled"] is True


def test_reclaim_only_dead_pids_of_the_port_prefix(tmp_path, pool_env):
    """reclaim_stale unlinks `jttshm_<dead pid>_*` only: never a live
    pid's segment, never the reference's `jtshm_*`."""
    d = tmp_path / "shm"
    d.mkdir()
    dead = 2 ** 22 + 12345
    names = [f"jttshm_{dead}_abc", f"jttshm_{os.getpid()}_abc",
             f"jtshm_{dead}_abc", "jttshm_x_y"]
    removed = []
    for n in names:
        (d / n).write_bytes(b"")
    pool_env.setattr(shm, "unlink_stale",
                     lambda n: removed.append(n) or True)
    assert shm.reclaim_stale(str(d)) == 1
    assert removed == [f"jttshm_{dead}_abc"]
    assert not shm.NAME_PREFIX.startswith("jtshm")


# -- the CLI with the pool on, against the reference's ---------------------

@pytest.fixture
def cli_pool_env(reference_env, pool_env):  # noqa: F811
    """Both CLIs on the CPU with a two-core `os.cpu_count`: each pools
    two workers. The reference dispatches on one device (no bucket
    padding to the tests' eight virtual devices) without buffer
    donation, which the port has not."""
    import jax
    mesh = ref_parallel.make_mesh(jax.devices()[:1])
    pool_env.setattr(ref_parallel, "make_mesh", lambda *a, **k: mesh)
    pool_env.setattr(os, "cpu_count", lambda: 2)
    pool_env.setenv("JEPSEN_TPU_BACKEND", "tpu")
    pool_env.setenv("JEPSEN_TPU_DONATE_BUFFERS", "0")
    return pool_env


#: counters of the pool and the encoder, compared in metrics.json
POOL_COUNTERS = ("shm_bytes", "shm_stale_reclaimed", "worker_spans",
                 "cache_hits", "cache_misses", "sidecar_upgrades",
                 "quarantined", "runs_verdicted")


@pytest.mark.parametrize("case", ["append", "append-v1", "wr", "register",
                                  "append-kill", "wr-kill"])
def test_pooled_cli_matches_reference(case, tmp_path, cli_pool_env, capsys):
    checker = case.split("-")[0]
    pristine = tmp_path / "pristine"
    if checker == "register":
        register_store(pristine)
    else:
        sweep_store(pristine, checker)
    if case.endswith("-v1"):
        cli_pool_env.setenv("JEPSEN_TPU_SIDECAR_V2", "0")
    if case.endswith("-kill"):
        cli_pool_env.setenv("JEPSEN_TPU_FAULT_INJECT", "kill:0.5")
    grabbed = []

    def grab(s):
        m = json.loads((s / "metrics.json").read_text())
        t = json.loads((s / "trace.json").read_text())["traceEvents"]
        grabbed.append((m, {e["args"]["name"].split(" ")[0] for e in t
                            if e["name"] == "process_name"}))

    got = in_turn(tmp_path, pristine,
                  [(["--checker", checker], None), grab], capsys)
    assert_same(got)
    (mr, pr), (mp, pp) = grabbed
    # under kill:, which results reached the parent before the pool
    # died is a matter of timing: only the verdict counters compare
    for k in (POOL_COUNTERS if not case.endswith("-kill")
              else ("quarantined", "runs_verdicted",
                    "shm_stale_reclaimed")):
        assert mr["counters"].get(k) == mp["counters"].get(k), k
    assert mp["counters"]["shm_stale_reclaimed"] == 0
    assert pr == pp
    rcs, _snap, out = got["port"]
    if checker == "register":
        return
    assert "ingest-worker" in pp
    if case.endswith("-kill"):
        # every run-00000 is selected: each is quarantined, the rest
        # verdicted as the reference verdicts them (assert_same above)
        quarantined = [json.loads(ln) for ln in out
                       if '"quarantined"' in ln]
        assert len(quarantined) == 3 and rcs == [2]
        assert {q["quarantined"] for q in quarantined} == {"encode"}
        assert {q["dir"].split("/")[-1] for q in quarantined} == \
            {"run-00000"}
        return
    assert mp["counters"]["worker_spans"] > 0
    assert ("shm_bytes" in mp["counters"]) == (checker == "wr"
                                               or case == "append-v1")

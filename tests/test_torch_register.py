"""The register slice end to end: `python -m jepsen_tpu_torch.cli
analyze-store --checker register --device cpu` against the JAX
package's `python -m jepsen_tpu.cli analyze-store --checker register
--backend tpu` on two copies of each store — one whose keys take every
tier (dense grid, bounded frontier, the CPU WGL oracle, valid and
invalid), and one with a dict-valued run that sinks the batch and sends
every key through the per-key isolation — plus the store writer, the
runs both send to their stored checker, and the host build of the WGL
library.

Tolerance: byte-identical results.json / results.edn per run, identical
verdicts.jsonl lines, equal exit codes."""

import json
import os
import shutil
import stat
import subprocess
import sys
from pathlib import Path

import pytest

import bench
from jepsen_tpu_torch import _build, cli, ingest
from jepsen_tpu_torch.checker import knossos as pkn
from jepsen_tpu_torch.checker.knossos import dense
from jepsen_tpu_torch.checker.knossos import synth
from jepsen_tpu_torch.store import Store
from test_torch_cli import reference_env  # noqa: F401
from test_torch_stored import assert_same, in_turn

REPO = Path(__file__).resolve().parent.parent


def op(type_, process, f, value=None):
    return {"type": type_, "process": process, "f": f, "value": value}


def lifted(k, hist: list[dict], process_base: int = 0) -> list[dict]:
    return [{**o, "process": o["process"] + process_base,
             "value": [k, o["value"]]} for o in hist]


def write_run(d: Path, hist: list[dict]) -> None:
    d.mkdir(parents=True)
    (d / "history.jsonl").write_text("".join(
        json.dumps({**o, "index": i}) + "\n" for i, o in enumerate(hist)))


def value_rich(k: int) -> list[dict]:
    """70 serial writes (past the grid's 64 values), then concurrent
    ops: the bounded frontier's key."""
    h = [o for v in range(70) for o in (op("invoke", 0, "write", v),
                                        op("ok", 0, "write", v))]
    return h + synth.synth_register_history(
        n_ops=20, n_procs=3, n_values=70, info_prob=0.0, seed=k)


def past_the_gate(first_read) -> list[dict]:
    """A read, 20 concurrent writes and a read: past the grid's 14
    slots, and a half-doubling peak of 40, past the frontier's gate of
    18 — the oracle's key (invalid when the first read sees a value)."""
    return ([op("invoke", 30, "read"), op("ok", 30, "read", first_read)]
            + [op("invoke", p, "write", p) for p in range(20)]
            + [op("ok", p, "write", p) for p in range(20)]
            + [op("invoke", 30, "read"), op("ok", 30, "read", 7)])


def mixed_store(base: Path) -> None:
    """Dense-tier runs (runs 1 and 3 invalid on key 0), and a run whose
    keys take the frontier and the oracle, valid and invalid."""
    synth.write_register_run_store(base, runs=4, ops=60, keys=4,
                                   bad_every=2)
    write_run(base / "mixed" / "run-00000",
              lifted(0, value_rich(0))
              + lifted(1, synth.corrupt(value_rich(1), seed=3), 10)
              + lifted(2, past_the_gate(None), 20)
              + lifted(3, past_the_gate(99), 60))


def isolation_store(base: Path) -> None:
    """A small register store and a run with a dict-valued key: the
    batch raises, and every key is checked alone."""
    synth.write_register_run_store(base, runs=2, ops=30, keys=3,
                                   bad_every=2)
    write_run(base / "odd" / "run-00000",
              lifted(0, synth.synth_register_history(n_ops=8, seed=5))
              + lifted(1, [op("invoke", 9, "write", {"a": 1}),
                           op("ok", 9, "write", {"a": 1})]))


def reference_cli(store: Path, tmp: Path) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # the reference's executable cache stays private to this test
    env["JEPSEN_TPU_AOT_CACHE"] = "0"
    env["JEPSEN_TPU_COMPILE_CACHE_DIR"] = str(tmp / "aot")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu.cli", "analyze-store", "--store",
         str(store), "--checker", "register", "--backend", "tpu"],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


STORES = {"mixed": mixed_store, "isolation": isolation_store}


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """Both stores through both CLIs: the reference in subprocesses
    (both at once), the port in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("register")
    procs, port = {}, {}
    for name, make in STORES.items():
        make(tmp / name / "ref")
        shutil.copytree(tmp / name / "ref", tmp / name / "port")
        procs[name] = reference_cli(tmp / name / "ref", tmp)
    for name in STORES:
        port[name] = cli.main(["analyze-store", "--store",
                               str(tmp / name / "port"), "--checker",
                               "register", "--device", "cpu"])
    ref = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        ref[name] = (proc.returncode, err)
    return tmp, ref, port


@pytest.mark.parametrize("name,rc", [("isolation", 2), ("mixed", 1)])
def test_exit_codes_match(swept, name, rc):
    _, ref, port = swept
    assert ref[name][0] == port[name] == rc, ref[name][1][-2000:]


@pytest.mark.parametrize("fname", ["results.json", "results.edn"])
@pytest.mark.parametrize("name", sorted(STORES))
def test_results_byte_identical(swept, name, fname):
    tmp, _, _ = swept
    runs = sorted(p.relative_to(tmp / name / "ref").parent
                  for p in (tmp / name / "ref").rglob("history.jsonl"))
    assert len(runs) >= 3
    for run in runs:
        a = (tmp / name / "ref" / run / fname).read_bytes()
        b = (tmp / name / "port" / run / fname).read_bytes()
        assert a == b, run


@pytest.mark.parametrize("name", sorted(STORES))
def test_journal_lines_identical(swept, name):
    tmp, _, _ = swept
    ref = (tmp / name / "ref" / "verdicts.jsonl").read_text().splitlines()
    port = (tmp / name / "port" / "verdicts.jsonl").read_text().splitlines()
    assert ref == port


def results(tmp: Path, name: str, run: str) -> dict:
    return json.loads((tmp / name / "port" / run / "results.json")
                      .read_text())


def test_mixed_store_takes_every_tier(swept):
    tmp, _, _ = swept
    for r in range(4):
        res = results(tmp, "mixed", f"register/run-{r:05d}")
        assert res["failures"] == (["0"] if r % 2 else [])
        assert {v["analyzer"] for v in res["results"].values()} \
            == {"tpu-dense"}
    res = results(tmp, "mixed", "mixed/run-00000")
    assert [(v["analyzer"], v["valid?"]) for v in res["results"].values()] \
        == [("tpu-jit", True), ("tpu-jit", False), ("wgl", True),
            ("wgl", False)]
    assert res["results"]["3"]["op"]["value"] == 99


def test_isolation_store_degrades_only_the_dict_key(swept):
    tmp, _, _ = swept
    res = results(tmp, "isolation", "odd/run-00000")
    assert res["valid?"] == "unknown"
    assert res["results"]["0"]["valid?"] is True
    assert res["results"]["1"] == {
        "valid?": "unknown", "error": "TypeError(\"unhashable type: 'dict'\")"}
    assert results(tmp, "isolation", "register/run-00001")["failures"] \
        == ["0"]


def test_register_store_is_the_bench_store(tmp_path):
    """The two-level store holds the reference bench's register runs,
    byte for byte."""
    dirs = synth.write_register_run_store(tmp_path / "s", runs=3, ops=40,
                                          keys=5, bad_every=2)
    (tmp_path / "flat").mkdir()
    flat = bench._write_register_store(tmp_path / "flat", 3, 40, 5, 2)
    assert [d.name for d in dirs] == [f"run-{r:05d}" for r in range(3)]
    for d, f in zip(dirs, flat):
        assert (d / "history.jsonl").read_bytes() == \
            (f / "history.jsonl").read_bytes()


def test_unported_runs_are_named_not_verdicted(tmp_path, capsys,
                                               reference_env, monkeypatch):
    """The runs the reference sends to its stored checker — not
    register-shaped, lifted-looking but declined by relift (no ok read),
    unloadable — get its verdicts, in run order among the checked runs.
    The unloadable run's error holds its path, so both CLIs sweep one
    path in turn."""
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    store = tmp_path / "pristine"
    synth.write_register_run_store(store, runs=1, ops=20, keys=2,
                                   bad_every=0)
    write_run(store / "other" / "run-00000",
              [op("invoke", 0, "enqueue", 1), op("ok", 0, "enqueue", 1)])
    write_run(store / "other" / "run-00001",
              lifted(0, [op("invoke", 0, "write", 1),
                         op("ok", 0, "write", 1)]))
    (store / "other" / "run-00002").mkdir()
    got = in_turn(tmp_path, store, [(["--checker", "register"], None)],
                  capsys)
    assert_same(got)
    rcs, snap, _ = got["port"]
    assert rcs == [2]
    lines = [json.loads(ln) for ln in snap["verdicts.jsonl"]]
    assert [(ln["dir"], ln["valid?"]) for ln in lines] == [
        ("other/run-00000", True), ("other/run-00001", True),
        ("other/run-00002", "unknown"), ("register/run-00000", True)]
    assert lines[2]["quarantined"] == "stored"
    assert "no history in" in lines[2]["error"]
    assert json.loads(snap["register/run-00000/results.json"])[
        "key-count"] == 2


def test_register_log_and_plain_scan(tmp_path):
    store = tmp_path / "s"
    synth.write_register_run_store(store, runs=2, ops=40, keys=4,
                                   bad_every=2)
    log: dict = {}
    rc = cli.analyze_store(Store(store), checker="register", device="cpu",
                           dense_scan=dense.scan_dense_ref,
                           register_log=log)
    assert rc == 1 and log["keys"] == 8
    assert [t["tier"] for t in log["tiers"]] == ["tpu-dense"]
    assert all(log[k] >= 0 for k in ("load_s", "split_s", "check_s"))


def test_cli_without_cuda_exits_255(tmp_path, monkeypatch):
    synth.write_register_run_store(tmp_path / "s", runs=1, ops=20, keys=2,
                                   bad_every=0)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert cli.main(["analyze-store", "--store", str(tmp_path / "s"),
                     "--checker", "register"]) == 255
    assert not list((tmp_path / "s").rglob("results.json"))


def test_build_failure_is_not_isolated_per_key(tmp_path, monkeypatch):
    """A kernel that cannot be built is no run's fault: the sweep
    raises instead of writing "unknown" verdicts."""
    synth.write_register_run_store(tmp_path / "s", runs=1, ops=20, keys=2,
                                   bad_every=0)

    def no_kernel(*a, **kw):
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(dense, "check_encoded_dense_batch", no_kernel)
    with pytest.raises(_build.KernelBuildError):
        cli.analyze_store(Store(tmp_path / "s"), checker="register",
                          device="cpu")


def test_load_runs_isolates_each_run(tmp_path):
    synth.write_register_run_store(tmp_path / "s", runs=1, ops=20, keys=2,
                                   bad_every=0)
    got = ingest.load_runs([tmp_path / "s" / "register" / "run-00000",
                            tmp_path / "missing"])
    assert isinstance(got[0], list) and len(got[0]) > 0
    assert isinstance(got[1], FileNotFoundError)


def test_wgl_build_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.find_cxx() is None
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ not found"):
        _build.load("wgl")
    # the native engine raises too: no quiet switch to the Python one
    with pytest.raises(_build.KernelBuildError):
        pkn._wgl_native([op("invoke", 0, "read"), op("ok", 0, "read")],
                        100)


def test_wgl_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'error: no such file wgl.cc' >&2\n"
                   "exit 1\n")
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="no such file"):
        _build.build("wgl")
    assert not any((tmp_path / "build").iterdir())


def test_host_build_key_follows_source_and_flags(monkeypatch):
    a = _build.library_path("wgl", "/x/g++")
    monkeypatch.setattr(_build, "CXX_FLAGS", _build.CXX_FLAGS + ("-g",))
    b = _build.library_path("wgl", "/x/g++")
    assert a != b and a.parent == b.parent == _build.BUILD_DIR
    assert a.name.startswith("wgl-")


def test_wgl_source_is_the_reference_copy():
    assert (REPO / "jepsen_tpu_torch" / "csrc" / "wgl.cc").read_bytes() \
        == (REPO / "native" / "wgl.cc").read_bytes()

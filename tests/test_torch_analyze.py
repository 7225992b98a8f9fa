"""`run_cli`'s `analyze` of the port against the reference's, and
`analyze-store --backend`.

`analyze` re-runs a suite's checker (here: what a suite composes — an
Elle list-append checker with stats and unhandled exceptions, the
rw-register checker, `independent.checker` of linearizability by both
routes) on one stored run: both CLIs in this process, each package on
the same store path in turn, the port's checkers on `device="cpu"`
against the reference's device path on CPU XLA. Then `test` and
`test-all` running the noop test (their parity with the reference is
tests/test_torch_core_run.py's), and what the port refuses: a kernel
failure or a missing device, which exits 255 and writes no verdict. Last,
`analyze-store --backend cpu` (the host oracles) and `--backend race`
over a mixed store.

Tolerance: equal exit codes and stdout lines; every file the analysis
writes byte-identical (results.json, results.edn, test.json, elle/*,
independent/<k>/*, timeline.html, linear.svg) and the links equal, but
for trace.json and metrics.json, which must exist in both."""

import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import pytest

import jepsen_tpu.checker as ref_checker
import jepsen_tpu.checker.elle as ref_elle
import jepsen_tpu.checker.elle.wr as ref_wr
import jepsen_tpu.cli as ref_cli
import jepsen_tpu.independent as ref_ind
import jepsen_tpu_torch.checker as port_checker
import jepsen_tpu_torch.checker.elle as port_elle
import jepsen_tpu_torch.checker.elle.wr as port_wr
import jepsen_tpu_torch.independent as port_ind
from jepsen_tpu_torch import _build, cli
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.knossos import synth as ksynth
from test_torch_cli import reference_env  # noqa: F401
from test_torch_stored import assert_same, in_turn, mixed_store

PKGS = {"ref": (ref_cli, ref_checker, ref_elle, ref_wr, ref_ind, {}),
        "port": (cli, port_checker, port_elle, port_wr, port_ind,
                 {"device": "cpu"})}
#: written per run, but timed: compared by presence only
TIMED = ("trace.json", "metrics.json")


def append_suite(pkg: str):
    _cli, c, elle, _wr, _ind, dev = PKGS[pkg]
    return c.compose({"elle": elle.append_checker(backend="tpu", **dev),
                      "stats": c.stats(),
                      "exceptions": c.unhandled_exceptions()})


def wr_suite(pkg: str):
    wr, dev = PKGS[pkg][3], PKGS[pkg][5]
    return wr.rw_register_checker(backend="tpu", **dev)


def register_batch(pkg: str):
    _cli, c, _elle, _wr, ind, dev = PKGS[pkg]
    return ind.checker(c.linearizable(backend="tpu", **dev))


def register_fanout(pkg: str):
    _cli, c, _elle, _wr, ind, dev = PKGS[pkg]
    return ind.checker(c.compose({
        "timeline": c.timeline_checker(),
        "linear": c.linearizable(backend="tpu", **dev)}))


@pytest.fixture(scope="module")
def pristine(tmp_path_factory) -> Path:
    base = tmp_path_factory.mktemp("analyze") / "pristine"
    synth.write_synth_run_store(base, B=2, T=60, K=6, bad_every=2)
    synth.write_wr_run_store(base, B=2, T=60, K=6, bad_every=2)
    ksynth.write_register_run_store(base, runs=2, ops=120, keys=4,
                                    bad_every=2)
    return base


def snapshot(store: Path) -> dict:
    out = {}
    for p in sorted(store.rglob("*")):
        rel = str(p.relative_to(store))
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p))
        elif p.is_file():
            out[rel] = "timed" if p.name in TIMED else p.read_bytes()
    return out


def analyze_in_turn(tmp: Path, pristine: Path, make, argv: list[str],
                    capsys) -> dict:
    """`analyze <argv> --store <store>` with test_fn adding make(pkg) as
    the checker, each package in turn on one store path; {pkg: (exit
    code, snapshot, stdout lines)}."""
    got = {}
    work = tmp / "store"
    for pkg in PKGS:
        shutil.copytree(pristine, work, symlinks=True)
        argv_ = [str(work / a) if "/" in a else a for a in argv]
        rc = PKGS[pkg][0].run_cli(
            lambda t, a, pkg=pkg: {**t, "checker": make(pkg)},
            argv=["analyze", *argv_, "--store", str(work)])
        out = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
        got[pkg] = (rc, snapshot(work), out)
        shutil.move(str(work), tempfile.mkdtemp(dir=tmp))
    return got


def assert_analyzed_same(got: dict) -> None:
    (rc_r, snap_r, out_r), (rc_p, snap_p, out_p) = got["ref"], got["port"]
    assert rc_p == rc_r
    assert sorted(snap_p) == sorted(snap_r)
    for k, v in snap_r.items():
        assert snap_p[k] == v, k
    assert out_p == out_r


#: (suite, run dir (None: the store's latest), exit code, files the
#: port must have written under the run dir)
ANALYZE = {
    "append-valid": (append_suite, "synth/run-00000", 0, []),
    "append-g1c": (append_suite, "synth/run-00001", 1,
                   ["elle/G1c.txt", "elle/anomalies.edn"]),
    "wr-skew": (wr_suite, "wr/run-00001", 1,
                ["elle/G2-item.txt", "elle/anomalies.edn"]),
    "register-batch": (register_batch, "register/run-00001", 1,
                       ["independent/0/linear.svg",
                        "independent/3/results.edn",
                        "independent/3/history.edn"]),
    "register-fanout": (register_fanout, "register/run-00001", 1,
                        ["independent/0/linear.svg",
                         "independent/3/timeline.html"]),
    "register-latest": (register_batch, None, 1, []),
}


@pytest.mark.parametrize("case", list(ANALYZE))
def test_analyze_matches_reference(case, pristine, tmp_path, capsys,
                                   reference_env):  # noqa: F811
    make, run, rc, written = ANALYZE[case]
    got = analyze_in_turn(tmp_path, pristine, make,
                          [run] if run else [], capsys)
    assert_analyzed_same(got)
    rc_p, snap, out = got["port"]
    assert rc_p == rc
    # the store's latest: the first run dir of the greatest name
    run = run or "register/run-00001"
    for f in ("results.json", "results.edn", "test.json") + TIMED \
            + tuple(written):
        assert f"{run}/{f}" in snap, f
    assert json.loads(out[-1])["valid?"] is (rc == 0)


def test_analyze_without_runs_is_a_usage_error(tmp_path, capsys,
                                               reference_env):  # noqa: F811
    for mod in (ref_cli, cli):
        assert mod.run_cli(lambda t, a: t, argv=[
            "analyze", "--store", str(tmp_path / "empty")]) == 254


@pytest.mark.parametrize("command", ["test", "test-all"])
def test_running_a_test_runs_and_stores_it(command, tmp_path, capsys):
    """`test` and `test-all`, once refused, run the noop test map: a
    valid run whose test.json, history and results land in the store,
    and one result line naming its run dir."""
    assert cli.run_cli(lambda t, a: t, argv=[
        command, "--dummy", "--store", str(tmp_path)]) == 0
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out
               .splitlines() if ln.startswith("{")]
    assert line["valid?"] is True
    run = Path(line["dir"])
    assert run.parent.parent == tmp_path and run.parent.name == "noname"
    for f in ("test.json", "history.jsonl", "history.edn", "results.json",
              "results.edn"):
        assert (run / f).is_file(), f
    assert (tmp_path / "latest").resolve() == run.resolve()


def raising_checker(exc):
    def f(test, history, opts):
        raise exc
    return port_checker.compose({"stats": port_checker.stats(),
                                 "kernel": port_checker.FnChecker(f)})


@pytest.mark.parametrize("exc", [
    _build.KernelBuildError("nvcc failed building closure_square"),
    _build.KernelLaunchError("closure_square launch failed"),
], ids=["build", "launch"])
def test_kernel_failure_exits_255_and_writes_no_verdict(exc, pristine,
                                                        tmp_path, capsys):
    store = tmp_path / "store"
    shutil.copytree(pristine, store)
    run = store / "synth" / "run-00001"
    rc = cli.run_cli(lambda t, a: {**t, "checker": raising_checker(exc)},
                     argv=["analyze", str(run), "--store", str(store)])
    assert rc == 255
    assert not (run / "results.json").exists()
    assert not (run / "results.edn").exists()
    assert not [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]


def test_default_checker_without_a_card_exits_255(pristine, tmp_path,
                                                  capsys, monkeypatch):
    """A suite's default (auto) checker on a host without a card: the
    device path raises DeviceUnavailable, the analysis exits 255 and
    writes no verdict — the host oracle runs only when asked for."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "auto")
    store = tmp_path / "store"
    shutil.copytree(pristine, store)
    run = store / "synth" / "run-00001"

    def suite(t, a):
        return {**t, "checker": port_checker.compose({
            "elle": port_elle.append_checker(),
            "stats": port_checker.stats()})}
    assert cli.run_cli(suite, argv=["analyze", str(run), "--store",
                                    str(store)]) == 255
    assert not (run / "results.json").exists()
    assert "no CUDA device" in capsys.readouterr().err
    # asked for, the host oracle answers
    assert cli.run_cli(suite, argv=["analyze", str(run), "--store",
                                    str(store), "--backend", "cpu"]) == 1
    assert json.loads((run / "results.json").read_text())["elle"][
        "anomaly-types"] == ["G1c"]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory) -> Path:
    base = tmp_path_factory.mktemp("backend") / "pristine"
    mixed_store(base)
    return base


@pytest.mark.parametrize("checker,backend", [
    ("append", "cpu"), ("wr", "cpu"), ("register", "cpu"),
    ("register", "race"), ("append", "race")])
def test_analyze_store_backend_matches_reference(checker, backend, mixed,
                                                 tmp_path, capsys,
                                                 monkeypatch,
                                                 reference_env):  # noqa: F811
    """--backend is exported to JEPSEN_TPU_BACKEND by both CLIs (the
    setenv here restores it afterwards)."""
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "auto")
    got = in_turn(tmp_path, mixed,
                  [(["--checker", checker, "--backend", backend], None)],
                  capsys)
    assert_same(got)
    rcs, snap, _out = got["port"]
    assert rcs == [2]      # the unloadable `other` runs
    invalid = {k.split("/results.json")[0] for k, v in snap.items()
               if k.endswith("results.json")
               and json.loads(v).get("valid?") is False}
    assert invalid == {"append": {"synth/run-00002"},
                       "wr": {"wr/run-00001"},
                       "register": {"register/run-00001"}}[checker]


def test_analyze_store_cpu_backend_needs_no_device(mixed, tmp_path, capsys,
                                                   monkeypatch):
    """--backend cpu runs the host oracles: no device is resolved, so no
    card is needed, and no kernel is launched."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "auto")
    from jepsen_tpu_torch.checker.elle import kernels
    monkeypatch.setattr(kernels, "check_batch_device", None)
    store = tmp_path / "store"
    shutil.copytree(mixed, store)
    assert cli.main(["analyze-store", "--store", str(store), "--checker",
                     "append", "--backend", "cpu"]) == 2
    res = json.loads((store / "synth" / "run-00002" / "results.json")
                     .read_text())
    assert res["valid?"] is False
    assert res["anomalies"]["G1c"][0]["cycle-txns"], \
        "the host oracle records witness cycles"
    assert os.environ["JEPSEN_TPU_BACKEND"] == "auto"   # the export ended
    assert cli.main(["analyze-store", "--store", str(store), "--checker",
                     "append"]) == 255


def test_backend_export_ends_with_the_call(pristine, tmp_path, monkeypatch,
                                           capsys):
    """`--backend` holds for the call's checkers only: run_cli restores
    JEPSEN_TPU_BACKEND as it found it, unset or set."""
    store = tmp_path / "store"
    shutil.copytree(pristine, store)
    run = store / "synth" / "run-00001"
    seen = []

    def suite(t, a):
        seen.append(os.environ.get("JEPSEN_TPU_BACKEND"))
        return {**t, "checker": port_elle.append_checker(device="cpu")}
    argv = ["analyze", str(run), "--store", str(store), "--backend", "cpu"]
    monkeypatch.delenv("JEPSEN_TPU_BACKEND", raising=False)
    assert cli.run_cli(suite, argv=argv) == 1
    assert "JEPSEN_TPU_BACKEND" not in os.environ
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "race")
    assert cli.run_cli(suite, argv=argv) == 1
    assert os.environ["JEPSEN_TPU_BACKEND"] == "race"
    assert seen == ["cpu", "cpu"]


def test_race_device_failure_after_the_cpu_answered_writes_no_verdict(
        pristine, tmp_path, capsys, monkeypatch):
    """The race's CPU side answers, then its device side fails to
    launch: analyze settles the race before it writes the verdict, so
    it exits 255 and writes none."""
    store = tmp_path / "store"
    shutil.copytree(pristine, store)
    run = store / "register" / "run-00001"
    c = port_checker.linearizable(backend="race", device="cpu")

    def fails_late(*a, **kw):
        time.sleep(0.5)
        raise _build.KernelLaunchError("knossos_dense_scan launch failed")
    monkeypatch.setattr(c, "_device_batch", fails_late)
    rc = cli.run_cli(lambda t, a: {**t, "checker": port_ind.checker(c)},
                     argv=["analyze", str(run), "--store", str(store)])
    assert rc == 255
    assert not (run / "results.json").exists()
    assert not port_checker.Linearizable._race_errors
    from jepsen_tpu_torch import trace
    counters = trace.get_current().metrics_dict()["counters"]
    assert counters.get("race_won_cpu") == 1
    assert counters.get("race_device_error") == 1


def test_test_map_from_args_matches_reference(tmp_path):
    """The base test map a suite's test_fn receives, from the same
    options (the store compared by its base)."""
    nodes = tmp_path / "nodes"
    nodes.write_text("n3\n\nn4\n")
    argv = ["--node", "n1", "-n", "n2", "--nodes-file", str(nodes),
            "--concurrency", "3n", "--faults", "partition, kill",
            "--backend", "race", "--store", str(tmp_path / "s")]
    maps = []
    for mod in (ref_cli, cli):
        import argparse
        p = argparse.ArgumentParser()
        mod.add_test_opts(p)
        t = mod.test_map_from_args(p.parse_args(argv))
        t["store"] = str(t["store"].base)
        maps.append(t)
    assert maps[0] == maps[1]
    assert maps[1]["nodes"] == ["n1", "n2", "n3", "n4"]

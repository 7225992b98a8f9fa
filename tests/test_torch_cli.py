"""The port's CLI against the reference's on what goes wrong: usage
errors and a long run whose check raises.

Both CLIs run in this process: the port's `cli.main(argv)`, and the
reference's `run_cli` as `python -m jepsen_tpu.cli` calls it. The
reference gets
`JEPSEN_TPU_AOT_CACHE=0` and a temporary `JEPSEN_TPU_COMPILE_CACHE_DIR`,
so its executable cache stays private to the test, and a one-core
`os.cpu_count`, so its ingest stays serial.

Tolerance: equal exit codes; byte-identical results.json / results.edn
per run and identical verdicts.jsonl lines."""

import json
import os
import shutil
from pathlib import Path

import pytest

import jepsen_tpu.cli as ref_cli
import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu_torch.parallel as port_parallel
from jepsen_tpu_torch import _build, cli, supervisor
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.devices import DeviceUnavailable

#: Runs past this many txns take the long (condensed) path in both
#: packages; the synthetic runs below have 200 txns each.
LONG_LIMIT = 100
N_RUNS, T, KEYS = 3, 200, 8
FAIL_CALL = 1          # the second long run's check raises
FAULT = "injected: condensed check of this run failed"


def ref_main(argv: list[str]) -> int:
    """`python -m jepsen_tpu.cli <argv>`, in this process."""
    return ref_cli.run_cli(lambda tmap, args: tmap, argv=list(argv))


@pytest.fixture
def reference_env(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path / "aot"))
    monkeypatch.delenv("JEPSEN_TPU_STRICT", raising=False)
    monkeypatch.delenv("JEPSEN_TPU_FAULT_INJECT", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 1)


@pytest.mark.parametrize("argv", [
    ["--bogus"],
    ["analyze-store", "--bogus"],
    ["analyze-store", "--checker", "bogus"],
    ["analyze-store", "--store"],
    [],
    ["--help"],
    ["analyze-store", "--help"],
], ids=["unknown-flag", "unknown-subflag", "bogus-checker",
        "missing-value", "no-command", "help", "subcommand-help"])
def test_usage_exit_code_matches_reference(argv, reference_env, capsys):
    want = 0 if "--help" in argv else 254
    assert ref_main(argv) == want
    assert cli.main(list(argv)) == want


@pytest.mark.parametrize("argv", [
    ["analyze-store", "--checker", "stored"],
    ["analyze-store", "--name", "x"],
])
def test_options_not_ported_are_usage_errors(argv, tmp_path, capsys):
    """The reference takes both; the port does not yet, and refuses them
    as usage errors (254), not as unknown validity (2)."""
    assert cli.main(argv + ["--store", str(tmp_path)]) == 254
    assert "usage:" in capsys.readouterr().err


def failing_long_check(monkeypatch, module, exc) -> list:
    """Replace `module.check_long_history` with one that raises `exc`
    on call FAIL_CALL and checks every other run as before; returns the
    list of calls made."""
    real = module.check_long_history
    calls: list = []

    def check(enc, *args, **kw):
        calls.append(enc.n)
        if len(calls) - 1 == FAIL_CALL:
            raise exc
        return real(enc, *args, **kw)

    monkeypatch.setattr(module, "check_long_history", check)
    monkeypatch.setattr(module, "DENSE_TXN_LIMIT", LONG_LIMIT)
    return calls


def runs_of(store: Path) -> list[Path]:
    return sorted(p.parent for p in store.rglob("history.jsonl"))


def test_failing_long_run_is_quarantined_like_the_reference(
        tmp_path, reference_env, monkeypatch, capsys):
    """DENSE_TXN_LIMIT is lowered through monkeypatch in both packages'
    `parallel` modules, so every run takes the long path; the second
    run's `check_long_history` raises the same RuntimeError in both."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    synth.write_synth_run_store(ref, B=N_RUNS, T=T, K=KEYS, bad_every=0)
    shutil.copytree(ref, port)
    ref_calls = failing_long_check(monkeypatch, ref_parallel,
                                   RuntimeError(FAULT))
    port_calls = failing_long_check(monkeypatch, port_parallel,
                                    RuntimeError(FAULT))

    rc_ref = ref_main(["analyze-store", "--store", str(ref),
                           "--checker", "append"])
    rc_port = cli.main(["analyze-store", "--store", str(port), "--checker",
                        "append", "--device", "cpu"])
    capsys.readouterr()
    assert rc_ref == rc_port == 2
    assert ref_calls == port_calls == [T] * N_RUNS

    runs = runs_of(ref)
    assert len(runs) == N_RUNS
    for d in runs:
        for fname in ("results.json", "results.edn"):
            assert (d / fname).read_bytes() == \
                (port / d.relative_to(ref) / fname).read_bytes(), (d, fname)
    lines = (port / "verdicts.jsonl").read_text().splitlines()
    assert (ref / "verdicts.jsonl").read_text().splitlines() == lines
    assert len(lines) == N_RUNS
    assert supervisor.quarantine_verdict(FAULT, "check", "append") == \
        json.loads(
            (port / runs[FAIL_CALL].relative_to(ref) / "results.json")
            .read_text())
    # the run after the failing one still got its verdict
    assert '"valid?": true' in lines[-1]


@pytest.mark.parametrize("exc", [
    _build.KernelBuildError("nvcc failed building closure_square"),
    DeviceUnavailable("no CUDA device"),
], ids=["build", "device"])
def test_build_and_device_errors_are_not_quarantined(
        tmp_path, monkeypatch, capsys, exc):
    """A failure that is no run's fault ends the sweep (255) and writes
    no verdict for the run it hit, nor for the runs after it."""
    store = tmp_path / "s"
    synth.write_synth_run_store(store, B=N_RUNS, T=T, K=KEYS, bad_every=0)
    calls = failing_long_check(monkeypatch, port_parallel, exc)
    rc = cli.main(["analyze-store", "--store", str(store), "--checker",
                   "append", "--device", "cpu"])
    capsys.readouterr()
    assert rc == 255
    assert len(calls) == FAIL_CALL + 1
    verdicted = [d for d in runs_of(store) if (d / "results.json").exists()]
    assert verdicted == runs_of(store)[:FAIL_CALL]

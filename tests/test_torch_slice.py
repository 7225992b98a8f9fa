"""The ported slice end to end: `python -m jepsen_tpu_torch.cli
analyze-store --checker append --device cpu` against the JAX package's
`python -m jepsen_tpu.cli analyze-store --checker append` on two copies
of one store.

Tolerance: byte-identical results.json / results.edn per run, identical
verdicts.jsonl lines, equal exit codes."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from jepsen_tpu_torch import cli
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.elle.closure_square import closure_square_ref
from jepsen_tpu_torch.store import Store

REPO = Path(__file__).resolve().parent.parent
N_RUNS, T, KEYS, BAD_EVERY = 6, 300, 16, 3   # runs 2 and 5 carry G1c


def run_cli(module: str, store: Path, *extra: str, tmp: Path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # the reference's executable cache stays private to this test
    env["JEPSEN_TPU_AOT_CACHE"] = "0"
    env["JEPSEN_TPU_COMPILE_CACHE_DIR"] = str(tmp / "aot")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", module, "analyze-store", "--store",
         str(store), "--checker", "append", *extra],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    synth.write_synth_run_store(tmp / "ref", B=N_RUNS, T=T, K=KEYS,
                                bad_every=BAD_EVERY)
    shutil.copytree(tmp / "ref", tmp / "port")
    ref = run_cli("jepsen_tpu.cli", tmp / "ref", tmp=tmp)
    port = run_cli("jepsen_tpu_torch.cli", tmp / "port", "--device", "cpu",
                   tmp=tmp)
    return tmp, ref, port


def test_exit_codes_match(swept):
    _, ref, port = swept
    assert ref.returncode == port.returncode == 1, (ref.stderr[-2000:],
                                                    port.stderr[-2000:])


@pytest.mark.parametrize("fname", ["results.json", "results.edn"])
def test_results_byte_identical(swept, fname):
    tmp, _, _ = swept
    runs = sorted(p.name for p in (tmp / "ref" / "synth").iterdir())
    assert len(runs) == N_RUNS
    for run in runs:
        a = (tmp / "ref" / "synth" / run / fname).read_bytes()
        b = (tmp / "port" / "synth" / run / fname).read_bytes()
        assert a == b, run


def test_journal_lines_identical(swept):
    tmp, _, _ = swept
    ref = (tmp / "ref" / "verdicts.jsonl").read_text().splitlines()
    port = (tmp / "port" / "verdicts.jsonl").read_text().splitlines()
    assert ref == port
    bad = [json.loads(ln)["dir"] for ln in port
           if json.loads(ln)["valid?"] is False]
    assert bad == ["synth/run-00002", "synth/run-00005"]


def test_summary_lines_name_g1c(swept):
    _, _, port = swept
    lines = [json.loads(ln) for ln in port.stdout.splitlines()]
    assert [ln["anomalies"] for ln in lines].count(["G1c"]) == 2


def test_cli_without_cuda_exits_nonzero(tmp_path, monkeypatch):
    synth.write_synth_run_store(tmp_path / "s", B=1, T=50, K=4, bad_every=0)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert cli.main(["analyze-store", "--store", str(tmp_path / "s")]) == 255
    assert not list((tmp_path / "s").rglob("results.json"))


def test_unported_runs_are_named_not_verdicted(tmp_path, monkeypatch,
                                               capsys):
    store = tmp_path / "s"
    synth.write_synth_run_store(store, B=2, T=200, K=4, bad_every=0)
    (store / "synth" / "run-00002").mkdir()
    (store / "synth" / "run-00002" / "history.jsonl").write_text(
        '{"type":"invoke","process":0,"f":"read","value":null,"index":0}\n')
    monkeypatch.setattr("jepsen_tpu_torch.parallel.DENSE_TXN_LIMIT", 100)
    rc = cli.analyze_store(Store(store), device="cpu")
    err = capsys.readouterr().err
    assert rc == 2
    assert err.count(cli.NOT_PORTED) == 3
    assert not list(store.rglob("results.json"))


def test_plain_square_gives_identical_verdicts(tmp_path):
    for sub in ("a", "b"):
        synth.write_synth_run_store(tmp_path / sub, B=3, T=200, K=8,
                                    bad_every=2)
    log_a: list = []
    assert cli.analyze_store(Store(tmp_path / "a"), device="cpu",
                             bucket_log=log_a) == 1
    assert cli.analyze_store(Store(tmp_path / "b"), device="cpu",
                             square=closure_square_ref) == 1
    for run in ("run-00000", "run-00001", "run-00002"):
        for f in ("results.json", "results.edn"):
            assert (tmp_path / "a" / "synth" / run / f).read_bytes() == \
                (tmp_path / "b" / "synth" / run / f).read_bytes()
    assert [b["histories"] for b in log_a] == [3]
    assert log_a[0]["t_pad"] == 256 and len(log_a[0]["closure_rounds"]) == 3

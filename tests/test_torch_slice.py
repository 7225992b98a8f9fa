"""The ported slice end to end: `python -m jepsen_tpu_torch.cli
analyze-store --checker append|wr --device cpu` against the JAX
package's `python -m jepsen_tpu.cli analyze-store` on two copies of one
store — dense list-append runs, list-append runs past a lowered
`DENSE_TXN_LIMIT` (set in both packages; the SCC-condensation path) and
rw-register runs.

Tolerance: byte-identical results.json / results.edn per run, identical
verdicts.jsonl lines, equal exit codes."""

import json
import os
import random
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from jepsen_tpu_torch import cli
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.elle.closure_square import closure_square_ref
from jepsen_tpu_torch.store import Store
from test_fuzz_differential import rand_wr_history
from test_torch_cli import ref_main, reference_env  # noqa: F401
from test_torch_stored import snapshot

REPO = Path(__file__).resolve().parent.parent
N_RUNS, T, KEYS, BAD_EVERY = 6, 300, 16, 3   # runs 2 and 5 carry G1c


def run_cli(module: str, store: Path, *extra: str, tmp: Path,
            checker: str = "append", dense_limit: int | None = None):
    """`python -m <module> analyze-store` in a subprocess; with
    `dense_limit`, the module's package gets that DENSE_TXN_LIMIT first."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # the reference's executable cache stays private to this test
    env["JEPSEN_TPU_AOT_CACHE"] = "0"
    env["JEPSEN_TPU_COMPILE_CACHE_DIR"] = str(tmp / "aot")
    env["JAX_PLATFORMS"] = "cpu"
    argv = [module, "analyze-store", "--store", str(store), "--checker",
            checker, *extra]
    if dense_limit is None:
        cmd = [sys.executable, "-m", *argv]
    else:
        pkg = module.split(".")[0]
        cmd = [sys.executable, "-c",
               f"import runpy, sys; sys.argv = {argv!r}; "
               f"import {pkg}.parallel as p; "
               f"p.DENSE_TXN_LIMIT = {dense_limit}; "
               f"runpy.run_module({module!r}, run_name='__main__')"]
    return subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                          text=True, timeout=600)


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
                                               capsys, reference_env):
    """Runs past the dense limit are condensed, and a txn-less run goes
    to its stored checker: every run gets the reference CLI's verdict
    (DENSE_TXN_LIMIT lowered in both packages)."""
    store, ref = tmp_path / "s", tmp_path / "ref"
    synth.write_synth_run_store(store, B=2, T=200, K=4, bad_every=0)
    (store / "synth" / "run-00002").mkdir()
    (store / "synth" / "run-00002" / "history.jsonl").write_text(
        '{"type":"invoke","process":0,"f":"read","value":null,"index":0}\n')
    shutil.copytree(store, ref, symlinks=True)
    monkeypatch.setattr("jepsen_tpu_torch.parallel.DENSE_TXN_LIMIT", 100)
    monkeypatch.setattr("jepsen_tpu.parallel.DENSE_TXN_LIMIT", 100)
    log: list = []
    rc = cli.analyze_store(Store(store), device="cpu", condense_log=log)
    rc_ref = ref_main(["analyze-store", "--store", str(ref)])
    capsys.readouterr()
    assert rc == rc_ref == 0
    assert snapshot(store) == snapshot(ref)
    assert [r["n"] for r in log] == [200, 200]
    assert json.loads((store / "synth" / "run-00002" / "results.json")
                      .read_text()) == {"valid?": True}
    assert json.loads((store / "synth" / "run-00002" / "test.json")
                      .read_text()) == {"start-time": "run-00002",
                                        "name": "synth"}
    assert [json.loads(ln)["dir"] for ln in
            (store / "verdicts.jsonl").read_text().splitlines()] == \
        ["synth/run-00000", "synth/run-00001", "synth/run-00002"]


@pytest.mark.parametrize("checker", ["append", "wr"])
def test_unencodable_runs_are_named(tmp_path, capsys, checker,
                                    reference_env):
    """A run that does not parse goes to the stored checker, whose load
    fails too: it is quarantined, as the reference does it, and the
    sweep exits 2."""
    store, ref = tmp_path / "s", tmp_path / "ref"
    if checker == "wr":
        synth.write_wr_run_store(store, B=1, T=50, K=4, bad_every=0,
                                 name="synth")
    else:
        synth.write_synth_run_store(store, B=1, T=50, K=4, bad_every=0)
    bad = store / "synth" / "run-00001"
    bad.mkdir()
    (bad / "history.jsonl").write_text("{not json\n")
    shutil.copytree(store, ref, symlinks=True)
    rc = cli.analyze_store(Store(store), checker=checker, device="cpu")
    rc_ref = ref_main(["analyze-store", "--store", str(ref), "--checker",
                       checker])
    capsys.readouterr()
    assert rc == rc_ref == 2
    assert snapshot(store) == snapshot(ref)
    res = json.loads((bad / "results.json").read_text())
    assert res["valid?"] == "unknown" and res["quarantined"] == "stored"
    assert json.loads((bad / f".sweep-{checker}").read_text()) == \
        {"valid?": "unknown"}
    assert json.loads((store / "synth" / "run-00000" / "results.json")
                      .read_text())["valid?"] is True


# The new paths against the reference CLI. "long": dense list-append runs
# beside runs past a DENSE_TXN_LIMIT lowered to 1,000 in both packages
# (valid, adjacent G1c pair, future read: an SCC of ~250 txns) — rc 1;
# "wr": rw-register runs, every third with a write-skew pair (G2-item),
# plus two corrupted fuzz runs (host anomalies, lean witnesses) — rc 1.
LONG_LIMIT = 1_000


def write_wr_store(base: Path) -> None:
    synth.write_wr_run_store(base, B=6, T=300, K=8, bad_every=3)
    for i, seed in enumerate((5, 12)):
        rng = random.Random(seed)
        d = base / "fuzz" / f"run-{i:05d}"
        d.mkdir(parents=True)
        d.joinpath("history.jsonl").write_text("".join(
            json.dumps(o) + "\n"
            for o in rand_wr_history(rng, 120, 6, 6)))


@pytest.fixture(scope="module", params=["long", "wr"])
def swept_new(request, tmp_path_factory):
    kind = request.param
    tmp = tmp_path_factory.mktemp(f"slice-{kind}")
    if kind == "wr":
        write_wr_store(tmp / "ref")
        kw = dict(checker="wr")
    else:
        synth.write_synth_run_store(tmp / "ref", B=3, T=300, K=16,
                                    bad_every=2)
        synth.write_long_append_store(tmp / "ref", T=3_000, K=16,
                                      future_gap=1_003)
        kw = dict(dense_limit=LONG_LIMIT)
    shutil.copytree(tmp / "ref", tmp / "port")
    ref = run_cli("jepsen_tpu.cli", tmp / "ref", tmp=tmp, **kw)
    port = run_cli("jepsen_tpu_torch.cli", tmp / "port", "--device", "cpu",
                   tmp=tmp, **kw)
    return kind, tmp, ref, port


def test_new_paths_exit_codes_match(swept_new):
    _, _, ref, port = swept_new
    assert ref.returncode == port.returncode == 1, (ref.stderr[-2000:],
                                                    port.stderr[-2000:])
    assert "quarantining" not in port.stderr


@pytest.mark.parametrize("fname", ["results.json", "results.edn",
                                   ".sweep-append", ".sweep-wr"])
def test_new_paths_results_byte_identical(swept_new, fname):
    kind, tmp, _, _ = swept_new
    runs = sorted(p.parent.relative_to(tmp / "ref")
                  for p in (tmp / "ref").rglob("history.jsonl"))
    assert len(runs) == (8 if kind == "wr" else 6)
    marker = fname.startswith(".sweep")
    want_marker = fname == (".sweep-wr" if kind == "wr" else ".sweep-append")
    for run in runs:
        a, b = tmp / "ref" / run / fname, tmp / "port" / run / fname
        if marker and not want_marker:
            assert not a.exists() and not b.exists(), run
            continue
        assert a.read_bytes() == b.read_bytes(), run


def test_new_paths_journal_lines_identical(swept_new):
    kind, tmp, _, _ = swept_new
    ref = (tmp / "ref" / "verdicts.jsonl").read_text().splitlines()
    port = (tmp / "port" / "verdicts.jsonl").read_text().splitlines()
    assert ref == port
    bad = {json.loads(ln)["dir"]: json.loads(ln)["valid?"] for ln in port}
    if kind == "long":
        # dense runs first, then the condensed ones, as the reference
        assert list(bad) == [f"synth/run-0000{i}" for i in range(3)] + \
            [f"long/run-0000{i}" for i in range(3)]
        assert [bad[f"long/run-0000{i}"] for i in range(3)] == \
            [True, False, False]
    else:
        assert [bad[f"wr/run-0000{i}"] for i in range(6)] == \
            [True, True, False, True, True, False]


def test_new_paths_condensed_or_g2_verdicts(swept_new):
    kind, tmp, _, _ = swept_new
    res = {p.parent.name: json.loads(p.read_text()) for p in
           (tmp / "port" / ("wr" if kind == "wr" else "long"))
           .rglob("results.json")}
    if kind == "wr":
        assert res["run-00002"]["anomaly-types"] == ["G2-item"]
    else:
        assert res["run-00001"]["anomaly-types"] == ["G1c"]
        assert "G1c" in res["run-00002"]["anomaly-types"]
        assert res["run-00002"]["txn-count"] == 3_000 > LONG_LIMIT


@pytest.mark.parametrize("kind", ["wr", "long"])
def test_plain_square_gives_identical_verdicts_on_new_paths(
        tmp_path, monkeypatch, kind):
    monkeypatch.setattr("jepsen_tpu_torch.parallel.DENSE_TXN_LIMIT",
                        LONG_LIMIT)
    for sub in ("a", "b"):
        if kind == "wr":
            synth.write_wr_run_store(tmp_path / sub, B=4, T=300, K=8,
                                     bad_every=2)
        else:
            synth.write_long_append_store(tmp_path / sub, T=2_000, K=16,
                                          future_gap=611)
    checker = "wr" if kind == "wr" else "append"
    log_a: list = []
    assert cli.analyze_store(Store(tmp_path / "a"), checker=checker,
                             device="cpu", bucket_log=log_a) == 1
    assert cli.analyze_store(Store(tmp_path / "b"), checker=checker,
                             device="cpu", square=closure_square_ref) == 1
    for p in (tmp_path / "a").rglob("results.*"):
        assert p.read_bytes() == \
            (tmp_path / "b" / p.relative_to(tmp_path / "a")).read_bytes()
    assert sum(b["histories"] for b in log_a) == (4 if kind == "wr" else 2)
    assert all(sum(b["closure_rounds"]) > 0 for b in log_a)


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

"""The rest of the port's `analyze-store` against the reference CLI:
`--checker stored`, the stored-checker fallback of the other checkers,
`--name` and `--resume`, and the fressian codec that loads the Clojure
reference's `test.fressian` runs.

Both CLIs run in this process (see tests/test_torch_cli.py): the port's
`cli.main(argv + ["--device", "cpu"])` and the reference's `run_cli`,
with `JEPSEN_TPU_AOT_CACHE=0`, a private `JEPSEN_TPU_COMPILE_CACHE_DIR`,
a one-core `os.cpu_count` and `JEPSEN_TPU_BACKEND=tpu` (the register
sweep's device tiers, on CPU XLA).

A quarantined run's verdict can hold its absolute path ("no history in
<dir>"), so the two packages sweep one path in turn: the pristine store
is copied in, swept, moved aside, and copied in again for the other.

A sweep is cut by making `VerdictJournal.record` raise
`KeyboardInterrupt` on its k-th call, in both packages: that run's
results and `.sweep-*` marker are written, its journal line is not, and
`--resume` skips it through the marker, so the journal ends one line
shorter than an uninterrupted sweep's.

Tolerance: exact. Equal exit codes; byte-identical results.json,
results.edn, test.json and `.sweep-<checker>` of every run; equal
`os.readlink` of the links; identical verdicts.jsonl and stdout
summary lines."""

import contextlib
import datetime
import json
import os
import shutil
import tempfile
from pathlib import Path

import pytest

import jepsen_tpu.cli as ref_cli
import jepsen_tpu.fressian as ref_fressian
import jepsen_tpu.store as ref_store
import test_fressian_golden as golden
from jepsen_tpu.history import history_to_edn
from jepsen_tpu_torch import cli, fressian
from jepsen_tpu_torch import edn as port_edn
from jepsen_tpu_torch import store as port_store
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.knossos import synth as ksynth
from test_torch_cli import ref_main, reference_env  # noqa: F401

PACKAGES = ("ref", "port")
CHECKERS = ("append", "wr", "register", "stored")
PER_RUN = ("results.json", "results.edn", "test.json")
#: runs of mixed_store, so verdicts of every sweep over it
N_RUNS = 13


def op(type_, process, f, value=None):
    return {"type": type_, "process": process, "f": f, "value": value}


def write_run(d: Path, hist: list[dict]) -> None:
    d.mkdir(parents=True)
    (d / "history.jsonl").write_text("".join(
        json.dumps({**o, "index": i}) + "\n" for i, o in enumerate(hist)))


def fressian_test_map() -> dict:
    """A Clojure-shaped test map as the reference's store writes it:
    keyword keys, a set, an inst, nested maps."""
    K = ref_fressian.Keyword
    return {K("name"): "other", K("concurrency"): 10,
            K("nodes"): ["n1", "n2"],
            K("start-time"): datetime.datetime(
                2020, 1, 1, tzinfo=datetime.timezone.utc),
            K("nemesis-tags"): {K("partition"), K("kill")},
            K("opts"): {K("rate"): 1.5, K("leader?"): True, K("x"): None}}


def mixed_store(base: Path) -> None:
    """Every kind of run a sweep meets: list-append (one G1c), rw-register
    (one G2-item) and lifted CAS-register runs (one invalid), and under
    `other` the runs the reference sends to its stored checker."""
    synth.write_synth_run_store(base, B=3, T=40, K=4, bad_every=3)
    synth.write_wr_run_store(base, B=2, T=40, K=4, bad_every=2)
    ksynth.write_register_run_store(base, runs=2, ops=24, keys=2,
                                    bad_every=2)
    other = base / "other"
    # txn-less and not register-shaped
    write_run(other / "run-00000", [op("invoke", 0, "enqueue", 1),
                                    op("ok", 0, "enqueue", 1)])
    # unloadable: a torn history
    (other / "run-00001").mkdir()
    (other / "run-00001" / "history.jsonl").write_text(
        '{"type": "invoke", "process": 0, "f": "rea')
    # no history at all
    (other / "run-00002").mkdir()
    # lifted-looking register values that relift declines (no ok read),
    # with a stored test map
    write_run(other / "run-00003", [op("invoke", 0, "write", [0, 1]),
                                    op("ok", 0, "write", [0, 1])])
    (other / "run-00003" / "test.json").write_text(json.dumps(
        {"name": "other", "concurrency": 3, "nodes": ["n1"]}))
    # the Clojure reference's layout: test.fressian and history.edn
    d = other / "run-00004"
    d.mkdir()
    (d / "test.fressian").write_bytes(
        ref_fressian.dumps(fressian_test_map()))
    (d / "history.edn").write_text(history_to_edn(
        synth.synth_append_history(T=12, K=3, seed=4)))
    # a torn history beside a results.json from the test run: a failed
    # stored check must leave that results.json as it was
    write_run(other / "run-00005", [])
    (other / "run-00005" / "history.jsonl").write_text("{\n")
    (other / "run-00005" / "results.json").write_text(
        json.dumps({"valid?": True, "from": "the test run"}))


@pytest.fixture
def env(reference_env, monkeypatch):  # noqa: F811
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")


@pytest.fixture(scope="module")
def pristine(tmp_path_factory) -> Path:
    base = tmp_path_factory.mktemp("stored") / "pristine"
    mixed_store(base)
    return base


@contextlib.contextmanager
def cut_at(k: int | None):
    """With k, the k-th `VerdictJournal.record` call of either package
    raises KeyboardInterrupt (the sweep exits 255)."""
    if k is None:
        yield
        return
    calls: list = []
    saved = [(c, c.record) for c in (ref_store.VerdictJournal,
                                     port_store.VerdictJournal)]

    def cutting(orig):
        def record(self, *a, **kw):
            calls.append(1)
            if len(calls) == k:
                raise KeyboardInterrupt
            return orig(self, *a, **kw)
        return record

    for c, orig in saved:
        c.record = cutting(orig)
    try:
        yield
    finally:
        for c, orig in saved:
            c.record = orig


def sweep(pkg: str, store: Path, argv: list[str]) -> int:
    argv = ["analyze-store", "--store", str(store), *argv]
    if pkg == "ref":
        return ref_main(argv)
    return cli.main(argv + ["--device", "cpu"])


def snapshot(store: Path) -> dict:
    """What a sweep leaves that the two packages must agree on: per-run
    files, markers, links (as `os.readlink` gives them) and the
    journal."""
    out = {}
    for root, dirs, files in os.walk(store):
        for nm in dirs + files:
            p = Path(root) / nm
            rel = str(p.relative_to(store))
            if p.is_symlink():
                out[rel] = ("link", os.readlink(p))
            elif p.is_file() and (nm in PER_RUN
                                  or nm.startswith(".sweep-")):
                out[rel] = p.read_bytes()
    j = store / "verdicts.jsonl"
    out["verdicts.jsonl"] = j.read_text().splitlines() if j.exists() \
        else None
    return out


def in_turn(tmp: Path, pristine: Path, steps: list, capsys,
            packages=PACKAGES) -> dict:
    """Each package in turn on the same path: copy `pristine` in, run
    `steps` — (argv, cut k or None), or a callable on the store — and
    move the store aside. Returns {package: (exit codes, snapshot,
    stdout lines)}."""
    work = tmp / "store"
    got = {}
    for pkg in packages:
        shutil.copytree(pristine, work, symlinks=True)
        rcs = []
        for step in steps:
            if callable(step):
                step(work)
                continue
            argv, k = step
            with cut_at(k):
                rcs.append(sweep(pkg, work, argv))
        out = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
        got[pkg] = (rcs, snapshot(work), out)
        shutil.move(str(work), tempfile.mkdtemp(dir=tmp))
    return got


def assert_same(got: dict) -> None:
    (rc_r, snap_r, out_r), (rc_p, snap_p, out_p) = got["ref"], got["port"]
    assert rc_r == rc_p
    assert sorted(snap_r) == sorted(snap_p)
    for k in snap_r:
        assert snap_r[k] == snap_p[k], k
    assert out_r == out_p


# -- whole sweeps ------------------------------------------------------

SWEEPS = {
    "stored": [["--checker", "stored"]],
    "append": [["--checker", "append"]],
    "wr": [["--checker", "wr"]],
    "register": [["--checker", "register"]],
    "name-stored": [["--checker", "stored", "--name", "other"]],
    "name-append": [["--checker", "append", "--name", "synth"]],
    "name-register": [["--checker", "register", "--name", "register"]],
    "name-nothing": [["--checker", "append", "--name", "nope"]],
    "name-nothing-resume": [["--checker", "wr", "--name", "nope",
                             "--resume"]],
    # every checker over the same store, each leaving its own marker
    "all-four": [["--checker", c] for c in CHECKERS],
}
SWEEP_RCS = {"stored": [2], "append": [2], "wr": [2], "register": [2],
             "name-stored": [2], "name-append": [1], "name-register": [1],
             "name-nothing": [254], "name-nothing-resume": [254],
             "all-four": [2, 2, 2, 2]}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_sweep_matches_reference(case, tmp_path, pristine, env, capsys):
    got = in_turn(tmp_path, pristine, [(a, None) for a in SWEEPS[case]],
                  capsys)
    assert_same(got)
    rcs, snap, out = got["port"]
    assert rcs == SWEEP_RCS[case]
    journal = snap["verdicts.jsonl"] or []
    if case.startswith("name-nothing"):
        assert journal == [] and out == []
        return
    if case == "name-stored":
        # only other's runs, and no synth run touched
        assert {json.loads(ln)["dir"].split("/")[0] for ln in journal} \
            == {"other"}
        assert not any(k.startswith("synth/") for k in snap)
        return
    n = {"name-append": 3, "name-register": 2, "all-four": 4 * N_RUNS}
    assert len(journal) == n.get(case, N_RUNS)


def test_stored_sweep_writes_what_the_reference_does(
        tmp_path, pristine, env, capsys):
    """The stored path's own artifacts: test.json (rewritten from
    test.json, test.fressian or the run dir alone), results, the links,
    and a failed check that keeps the run's earlier results.json."""
    got = in_turn(tmp_path, pristine, [(["--checker", "stored"], None)],
                  capsys)
    assert_same(got)
    _, snap, _ = got["port"]
    tj = json.loads(snap["other/run-00004/test.json"])
    assert tj["name"] == "other" and tj["start-time"] == "run-00004"
    assert tj["nemesis-tags"] == ["kill", "partition"]
    assert json.loads(snap["other/run-00003/test.json"])["concurrency"] == 3
    # links move forward only, by run name: run-00004 (run-00005's
    # check failed) stays ahead of every later test name's runs
    assert snap["latest"] == snap["current"] == ("link", "other/run-00004")
    assert snap["other/latest"] == ("link", "run-00004")
    assert json.loads(snap["other/run-00005/results.json"]) == \
        {"valid?": True, "from": "the test run"}
    assert json.loads(snap["other/run-00005/.sweep-stored"]) == \
        {"valid?": "unknown"}
    err = json.loads(snap["other/run-00002/results.json"])["error"]
    assert err.startswith("no history in ") and "run-00002" in err


#: (checker, DENSE_TXN_LIMIT or None) -> the runs checked on the device,
#: in the order their verdicts land. The fressian run holds a 12-txn
#: list-append history: a dense run for `append`, unencodable for `wr`;
#: at a limit of 30, synth's 40-txn runs take the long path, after it.
DEVICE_ORDER = {
    ("append", None): ["other/run-00004", "synth/run-00000",
                       "synth/run-00001", "synth/run-00002"],
    ("append", 30): ["other/run-00004", "synth/run-00000",
                     "synth/run-00001", "synth/run-00002"],
    ("wr", None): ["wr/run-00000", "wr/run-00001"],
}


@pytest.mark.parametrize("checker,limit", sorted(
    DEVICE_ORDER, key=lambda c: (c[0], c[1] or 0)))
def test_elle_fallback_runs_follow_the_device_runs(
        checker, limit, tmp_path, pristine, env, monkeypatch, capsys):
    """Dense runs first, in run order, then the long runs, then the
    fallback runs (txn-less, unencodable, empty), as the reference
    emits them."""
    condensed: list = []
    if limit is not None:
        import jepsen_tpu.parallel as ref_parallel
        import jepsen_tpu_torch.parallel as port_parallel
        for m in (ref_parallel, port_parallel):
            monkeypatch.setattr(m, "DENSE_TXN_LIMIT", limit)
        real = port_parallel.check_long_history
        monkeypatch.setattr(
            port_parallel, "check_long_history",
            lambda enc, *a, **kw: condensed.append(enc.n)
            or real(enc, *a, **kw))
    got = in_turn(tmp_path, pristine, [(["--checker", checker], None)],
                  capsys)
    assert_same(got)
    lines = [json.loads(ln) for ln in got["port"][1]["verdicts.jsonl"]]
    dirs = [ln["dir"] for ln in lines]
    device = DEVICE_ORDER[checker, limit]
    assert dirs[:len(device)] == device
    assert dirs[len(device):] == sorted(dirs[len(device):])
    assert condensed == ([40, 40, 40] if limit else [])
    assert {"other/run-00001", "other/run-00002", "other/run-00005"} <= \
        {ln["dir"] for ln in lines if "quarantined" in ln}


def test_register_fallback_runs_in_run_order(tmp_path, pristine, env,
                                             capsys):
    got = in_turn(tmp_path, pristine, [(["--checker", "register"], None)],
                  capsys)
    assert_same(got)
    lines = [json.loads(ln) for ln in got["port"][1]["verdicts.jsonl"]]
    assert [ln["dir"] for ln in lines] == sorted(ln["dir"] for ln in lines)
    by_dir = {ln["dir"]: ln for ln in lines}
    assert by_dir["register/run-00001"]["valid?"] is False
    res = json.loads(got["port"][1]["register/run-00001/results.json"])
    assert {r["analyzer"] for r in res["results"].values()} == \
        {"tpu-dense"}
    # relift declined and not register-shaped: the stored checker's
    # valid; unloadable: quarantined
    assert by_dir["other/run-00003"]["valid?"] is True
    assert by_dir["other/run-00000"]["valid?"] is True
    assert by_dir["other/run-00001"]["quarantined"] == "stored"


# -- cut and resumed sweeps --------------------------------------------

@pytest.mark.parametrize("k", [1, 7, N_RUNS], ids=["first", "middle",
                                                   "last"])
@pytest.mark.parametrize("checker", CHECKERS)
def test_cut_and_resumed_sweep_matches_reference(
        checker, k, tmp_path, pristine, env, capsys):
    got = in_turn(tmp_path, pristine,
                  [(["--checker", checker], k),
                   (["--checker", checker, "--resume"], None)], capsys)
    assert_same(got)
    rcs, snap, _ = got["port"]
    assert rcs == [255, 2]
    # the same per-run bytes as an uninterrupted sweep on the same
    # path, and its journal less the cut run's line
    (full_rc,), full, _ = in_turn(tmp_path, pristine,
                                  [(["--checker", checker], None)],
                                  capsys, packages=["port"])["port"]
    assert full_rc == 2
    journal = snap.pop("verdicts.jsonl")
    full_journal = full.pop("verdicts.jsonl")
    assert snap == full
    assert journal == full_journal[:k - 1] + full_journal[k:]


def drop_journal(store: Path) -> None:
    (store / "verdicts.jsonl").unlink()


RESUMES = {
    # all verdicted: "nothing to resume", the prior worst code
    "nothing-to-resume": [(["--checker", "stored"], None),
                          (["--checker", "stored", "--resume"], None)],
    # the prior worst code from .sweep-append alone: the stored sweep
    # rewrote synth's results.json as valid, the journal is gone, and
    # run 2's marker still says invalid
    "code-from-marker": [(["--checker", "append"], None),
                         (["--checker", "stored", "--name", "synth"], None),
                         drop_journal,
                         (["--checker", "append", "--name", "synth",
                           "--resume"], None)],
    # markers of another checker do not count
    "other-checker": [(["--checker", "append", "--name", "synth"], None),
                      (["--checker", "wr", "--name", "synth", "--resume"],
                       None)],
    # the journal alone: markers removed, results.json kept
    "journal-only": [(["--checker", "wr", "--name", "wr"], None),
                     lambda s: [p.unlink()
                                for p in s.rglob(".sweep-wr")],
                     lambda s: [p.write_text("{}")
                                for p in s.glob("wr/*/results.json")],
                     (["--checker", "wr", "--name", "wr", "--resume"],
                      None)],
}
RESUME_RCS = {"nothing-to-resume": [2, 2], "code-from-marker": [2, 0, 1],
              "other-checker": [1, 0], "journal-only": [1, 1]}


@pytest.mark.parametrize("case", sorted(RESUMES))
def test_resume_matches_reference(case, tmp_path, pristine, env, capsys):
    got = in_turn(tmp_path, pristine, RESUMES[case], capsys)
    assert_same(got)
    assert got["port"][0] == RESUME_RCS[case]


LEGACY = {
    # (marker text or None, results.json text or None)
    "empty-marker-invalid-results": ("", '{"valid?": false}'),
    "empty-marker-no-results": ("", None),
    "empty-marker-torn-results": ("", '{"valid'),
    "marker-unknown": ('{"valid?": "unknown"}', '{"valid?": true}'),
    "no-marker-results-naming-checker": (
        None, '{"valid?": false, "checker": "append"}'),
    "no-marker-results-other-checker": (
        None, '{"valid?": false, "checker": "wr"}'),
    "no-marker-torn-results": (None, '{"valid?'),
    "nothing": (None, None),
}


@pytest.mark.parametrize("checker", ["append", "stored"])
@pytest.mark.parametrize("case", sorted(LEGACY))
def test_verdicted_and_prior_code_match_reference(case, checker, tmp_path):
    marker, results = LEGACY[case]
    d = tmp_path / "run"
    d.mkdir()
    if marker is not None:
        (d / f".sweep-{checker}").write_text(marker)
    if results is not None:
        (d / "results.json").write_text(results)
    assert cli._verdicted(d, checker) == ref_cli._verdicted(d, checker)
    assert cli._prior_code(d, checker) == ref_cli._prior_code(d, checker)


# -- fressian ----------------------------------------------------------

def canon(v):
    """A value with its types spelled out by name, so values of the two
    packages' own classes compare."""
    t = type(v).__name__
    if isinstance(v, dict):
        return (t, [(canon(k), canon(x)) for k, x in v.items()])
    if isinstance(v, (set, frozenset)):
        return (t, sorted(repr(canon(x)) for x in v))
    if isinstance(v, (list, tuple)):
        return (t, [canon(x) for x in v])
    if t == "TaggedValue":
        return (t, v.tag, canon(v.values))
    return (t, v)


def to_port(v):
    """A reference-typed value with the port's Keyword and Symbol."""
    if isinstance(v, dict):
        return {to_port(k): to_port(x) for k, x in v.items()}
    if isinstance(v, (set, frozenset)):
        return {to_port(x) for x in v}
    if isinstance(v, list):
        return [to_port(x) for x in v]
    if type(v).__name__ in ("Keyword", "Symbol"):
        return getattr(port_edn, type(v).__name__)(str(v))
    return v


#: the byte strings of tests/test_fressian_golden.py, the ones its
#: tests spell inline included
GOLDEN_BYTES = (
    [raw for raw, _ in golden.INT_CASES + golden.GOLDEN]
    + [want for _, want in golden.WRITER_CANONICAL]
    + [golden.jvm_test_map_bytes(),
       bytes([0xE6, 0xCD, 0xCA, 0xF7, 0xDD]) + b"foo" + bytes([0x80]),
       bytes([0xE7, 0xCD, 0xCA, 0xF7, 0xDB]) + b"a"
       + bytes([0xCD, 0xCA, 0xF7, 0xDB]) + b"b" + bytes([0x80]),
       bytes([0xE6, 0xCD, 0xCA, 0xF7, 0xDB]) + b"a" + bytes([0xCC, 0x00]),
       bytes([0xE6, 0xEF, 0xE3, 0x06]) + b"custom"
       + bytes([0x01, 0x51, 0x2C, 0xA0, 0x05]),
       bytes([0xEF, 0xE3, 0x08]) + b"datetime"
       + bytes([0x01, 0x7B, 0x6F, 0x5E, 0x66, 0xE8, 0x00]),
       bytes([0xC0, 0xE6, 0xCD, 0xCA, 0xF7, 0xDB]) + b"a" + bytes([0x01]),
       bytes([0xC1, 0xE6, 0x01, 0x02]),
       bytes([0xC8, 0x7B, 0x6F, 0x5E, 0x66, 0xE8, 0x00])])


@pytest.mark.parametrize("raw", GOLDEN_BYTES, ids=lambda b: b.hex()[:24])
def test_fressian_golden_bytes_read_alike(raw):
    got = fressian.Reader(raw).read()
    want = ref_fressian.Reader(raw).read()
    assert canon(got) == canon(want)


@pytest.mark.parametrize("value", [v for v, _ in golden.WRITER_CANONICAL]
                         + [fressian_test_map()],
                         ids=lambda v: repr(v)[:24])
def test_fressian_writer_matches_reference(value):
    assert fressian.dumps(to_port(value)) == ref_fressian.dumps(value)


def test_reference_fressian_test_loads_alike(tmp_path):
    mixed_store(tmp_path / "s")
    d = tmp_path / "s" / "other" / "run-00004"
    got = port_store.Store(tmp_path / "s").load_test(d)
    want = ref_store.Store(tmp_path / "s").load_test(d)
    assert canon(got) == canon(want)
    assert got["name"] == "other" and got["start-time"] == "run-00004"
    assert got["concurrency"] == 10 and len(got["history"]) == 24

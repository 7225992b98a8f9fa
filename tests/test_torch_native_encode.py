"""The port's native history encoder (jepsen_tpu_torch/csrc/hist_encode.cc
through checker/elle/native_encode.py) against the reference's native
encoder and both packages' Python encoders, on the CPU (g++ builds the
library at first use).

Histories: list-append runs from both packages' `synth` (serial, with a
G1c pair) and rw-register runs (`wr_run_ops`, with a write-skew pair),
each given info and fail completions, an open invoke and nemesis ops
by a numpy generator from a seed; and the reference's fuzz generators
(`rand_append_history`, `rand_wr_history`, corrupt reads included).

Also: a file the native side declines (Python encoder, the reference's
fallback counters), JEPSEN_TPU_NO_NATIVE, the XXH64 hasher native
against pure Python, and a library that cannot be built, which raises
(no whole-store Python fallback).

Tolerance: exact. Every array equal, `key_names` equal, the lean
anomalies equal as ordered (name, witnesses) lists; hashes equal;
counters equal."""

import json
import random

import numpy as np
import pytest

import jepsen_tpu.checker.elle.encode as r_encode
import jepsen_tpu.checker.elle.native_encode as r_ne
import jepsen_tpu.checker.elle.synth as r_synth
import jepsen_tpu.checker.elle.wr as r_wr
import jepsen_tpu.ingest as r_ingest
import jepsen_tpu.native_lib as r_native_lib
import jepsen_tpu.store as r_store
import jepsen_tpu.trace as r_trace
from jepsen_tpu_torch import _build, cli, ingest, store, trace
from jepsen_tpu_torch.checker.elle import encode, native_encode, synth, wr
from test_fuzz_differential import rand_append_history, rand_wr_history
from test_torch_cli import reference_env  # noqa: F401

APPEND_FIELDS = ("appends", "reads", "status", "process", "invoke_index",
                 "complete_index")
WR_FIELDS = ("status", "process", "invoke_index", "complete_index")


def roughen(ops: list[dict], seed: int) -> list[dict]:
    """`ops` with, drawn by a numpy generator from `seed`: some ok
    completions turned info (crashed) or fail, an open invoke at the
    end, and nemesis ops in between; indices renumbered. Each invoke
    first takes its completion's writes (reads unknown), as a client
    records them: a crashed or failed txn is known by its invoke."""
    rng = np.random.default_rng(seed)
    out = []
    pending: dict = {}
    for o in ops:
        if rng.random() < 0.08:
            out.append({"type": "info", "process": "nemesis",
                        "f": str(rng.choice(["start-partition",
                                             "stop-partition", "kill"])),
                        "value": None if rng.random() < 0.5 else "all"})
        o = dict(o)
        if o["type"] == "invoke":
            pending[o["process"]] = o
        elif o["process"] in pending:
            pending.pop(o["process"])["value"] = [
                [f, k, None if f == "r" else v] for f, k, v in o["value"]]
        if o["type"] == "ok":
            r = rng.random()
            if r < 0.06:
                o["type"], o["value"] = "info", None
            elif r < 0.09:
                o["type"] = "fail"
        out.append(o)
    out.append({"type": "invoke", "process": 97, "f": "txn",
                "value": [["r", "k0" if isinstance(ops[0]["value"][0][1],
                                                   str) else 0, None]]})
    return [{**o, "index": i, "time": i * 100} for i, o in enumerate(out)]


def append_histories() -> dict:
    out = {}
    for seed in range(3):
        for pkg, syn in (("port", synth), ("ref", r_synth)):
            h = syn.synth_append_history(T=80, K=5, seed=seed, g1c=True)
            out[f"synth-{pkg}-{seed}"] = roughen(h, seed)
    rng = random.Random(2027)
    for i in range(3):
        out[f"fuzz-{i}"] = rand_append_history(
            rng, T=60, K=4, conc=5, info_p=0.1, corrupt_p=0.4)
    return out


def wr_histories() -> dict:
    out = {}
    for seed in range(3):
        out[f"synth-{seed}"] = roughen(
            synth.wr_run_ops(T=80, K=5, seed=seed, write_skew=True), seed)
    rng = random.Random(777)
    for i in range(3):
        out[f"fuzz-{i}"] = rand_wr_history(rng, T=60, K=4, conc=5,
                                           corrupt_p=0.4)
    return out


APPEND = append_histories()
WR = wr_histories()


def write_run(base, ops: list[dict], name: str = "run"):
    d = base / name
    d.mkdir(parents=True)
    (d / "history.jsonl").write_text(
        "".join(json.dumps(o) + "\n" for o in ops))
    return d


def same_append(a, b) -> None:
    assert (a.n, a.n_keys, a.max_pos) == (b.n, b.n_keys, b.max_pos)
    for f in APPEND_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert list(a.key_names) == list(b.key_names)
    assert list(a.anomalies.items()) == list(b.anomalies.items())


def same_wr(a, b) -> None:
    assert (a.n, a.key_count) == (b.n, b.key_count)
    assert [tuple(e) for e in a.edges] == [tuple(e) for e in b.edges]
    for f in WR_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert list(a.anomalies.items()) == list(b.anomalies.items())


@pytest.mark.parametrize("name", sorted(APPEND))
def test_append_encoders_agree(name, tmp_path):
    """Port native == reference native == port Python == reference
    Python (lean witnesses)."""
    ops = APPEND[name]
    jl = write_run(tmp_path, ops) / "history.jsonl"
    mine = native_encode.encode_history_file(jl)
    assert mine is not None, "the native side declined a plain history"
    ref = r_ne.encode_history_file(jl)
    py = encode.encode_history(ops)
    py.anomalies = encode.lean_anomalies(py)
    rpy = r_encode.encode_history(ops)
    rpy.anomalies = r_encode.lean_anomalies(rpy)
    for other in (ref, py, rpy):
        same_append(mine, other)
    assert mine.txn_ops == []
    assert (mine.status == encode.INFO).sum() >= 1


@pytest.mark.parametrize("name", sorted(WR))
def test_wr_encoders_agree(name, tmp_path):
    ops = WR[name]
    jl = write_run(tmp_path, ops) / "history.jsonl"
    mine = native_encode.encode_wr_history_file(jl)
    assert mine is not None, "the native side declined a plain history"
    ref = r_ne.encode_wr_history_file(jl)
    py = wr.encode_wr_history(ops)
    py.anomalies = wr.lean_wr_anomalies(py)
    rpy = r_wr.encode_wr_history(ops)
    rpy.anomalies = r_wr.lean_wr_anomalies(rpy)
    for other in (ref, py, rpy):
        same_wr(mine, other)
    assert mine.edges


#: Files the native side declines, per checker, as the reference's
#: tests/test_native_encode.py builds them.
DECLINED = {
    "append": [{"type": "invoke", "process": 0, "f": "txn",
                "value": [["append", 1.5, None]], "index": 0},
               {"type": "ok", "process": 0, "f": "txn",
                "value": [["append", 1.5, 1]], "index": 1}],
    "wr": [{"type": "invoke", "process": 0, "f": "txn",
            "value": [["w", "x", -2 ** 63], ["r", "x", None]], "index": 0},
           {"type": "ok", "process": 0, "f": "txn",
            "value": [["w", "x", -2 ** 63], ["r", "x", None]],
            "index": 1}],
}


def counters(tr) -> dict:
    return {k: v for k, v in tr.metrics_dict()["counters"].items()
            if k.startswith(("native_fallback", "cache_"))}


def encode_both(d, checker: str):
    """encode_run_dir of each package under a fresh tracer of its own,
    each on a fresh copy of `d` (no sidecar between them)."""
    import shutil
    out = []
    for pkg, ing, tr_mod in (("port", ingest, trace),
                             ("ref", r_ingest, r_trace)):
        work = d.parent / f"{d.name}-{pkg}"
        shutil.copytree(d, work)
        tr = tr_mod.fresh_run(f"encode-{pkg}")
        enc = ing.encode_run_dir(work, checker)
        out.append((enc, counters(tr),
                    sorted(p.name for p in work.iterdir())))
    return out


@pytest.mark.parametrize("checker", ["append", "wr"])
@pytest.mark.parametrize("no_native", [False, True],
                         ids=["declined", "no-native"])
def test_python_fallback_and_its_counters(checker, no_native, tmp_path,
                                          monkeypatch):
    """A file the native side declines goes through the Python encoder,
    as the reference's does, and is cached from Python; so does every
    file under JEPSEN_TPU_NO_NATIVE, where each call that wanted the
    library counts `native_fallback` as the reference counts it."""
    if no_native:
        # the reference memoizes its library per process: a fresh memo,
        # so the gate reaches it as it reaches a fresh process
        monkeypatch.setattr(r_native_lib, "_cached", {})
        monkeypatch.setenv("JEPSEN_TPU_NO_NATIVE", "1")
        ops = (APPEND if checker == "append" else WR)["fuzz-0"]
    else:
        monkeypatch.delenv("JEPSEN_TPU_NO_NATIVE", raising=False)
        ops = DECLINED[checker]
        jl = write_run(tmp_path / "probe", ops) / "history.jsonl"
        fn = native_encode.encode_history_file if checker == "append" \
            else native_encode.encode_wr_history_file
        assert fn(jl) is None
    d = write_run(tmp_path, ops)
    (mine, c_mine, files_mine), (ref, c_ref, files_ref) = \
        encode_both(d, checker)
    (same_append if checker == "append" else same_wr)(mine, ref)
    assert c_mine == c_ref
    assert files_mine == files_ref
    assert c_mine["cache_misses"] == 1
    if no_native:
        assert c_mine["native_fallback"] == \
            c_mine["native_fallback.hist_encode.cc"] >= 1
    else:
        assert "native_fallback" not in c_mine
    assert store.encoded_cache_path(d, checker).name in files_mine


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 300, 65535, 65536, 65537,
                               131073])
def test_xxh64_native_equals_python(n):
    """Native, the port's Python and the reference's, and both packages'
    cache-key hasher; around the 32-byte stripe and 64 KiB."""
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    L = native_encode.hist_lib()
    got = L.jt_xxh64_buf(data, len(data), 0)
    assert got == store.xxh64(data) == r_store.xxh64(data)
    assert store._buf_xxh64(data) == r_store._buf_xxh64(data) == got


def test_xxh64_every_length_to_300():
    """Every length 0..300 (the tail loops' every branch), one buffer."""
    buf = np.random.default_rng(300).integers(0, 256, 300,
                                              np.uint8).tobytes()
    L = native_encode.hist_lib()
    for n in range(301):
        assert L.jt_xxh64_buf(buf[:n], n, 0) == store.xxh64(buf[:n]) \
            == r_store.xxh64(buf[:n]), n


def test_native_lib_dir_loads_that_lib_or_raises(tmp_path, monkeypatch):
    """JEPSEN_TPU_NATIVE_LIB_DIR: the library built there is loaded (the
    port's build, under the reference's name); an empty directory
    raises instead of falling back."""
    import shutil
    built = _build.build("hist_encode")
    shutil.copy(built, tmp_path / native_encode.LIB_NAME)
    monkeypatch.setenv("JEPSEN_TPU_NATIVE_LIB_DIR", str(tmp_path))
    assert native_encode.hist_lib().jt_ha_abi_version() == 5
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("JEPSEN_TPU_NATIVE_LIB_DIR", str(empty))
    with pytest.raises(_build.KernelBuildError):
        native_encode.hist_lib()


@pytest.mark.parametrize("checker", ["append", "wr"])
def test_failed_build_ends_the_sweep(checker, tmp_path, monkeypatch,
                                     reference_env, capsys,  # noqa: F811
                                     caplog):
    """With the native gate on and no g++ on PATH, the sweep exits
    non-zero naming the build, writes no verdict and never runs the
    Python encoder; with JEPSEN_TPU_NO_NATIVE=1 the same store sweeps
    through the Python encoder."""
    if checker == "append":
        synth.write_synth_run_store(tmp_path / "s", B=3, T=30, K=4,
                                    bad_every=2)
    else:
        synth.write_wr_run_store(tmp_path / "s", B=3, T=30, K=4,
                                 bad_every=2)
    import os
    path, load = os.environ["PATH"], ingest.load_history_dir
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path / "no-compiler"))
    monkeypatch.delenv("JEPSEN_TPU_NO_NATIVE", raising=False)
    monkeypatch.delenv("JEPSEN_TPU_NATIVE_INGEST", raising=False)
    python_loads = []
    monkeypatch.setattr(ingest, "load_history_dir",
                        lambda d: python_loads.append(d) or load(d))
    argv = ["analyze-store", "--store", str(tmp_path / "s"), "--checker",
            checker, "--device", "cpu"]
    assert cli.main(argv) == 255
    said = capsys.readouterr().err + caplog.text
    assert "KernelBuildError" in said and "hist_encode" in said
    assert python_loads == []
    assert not list((tmp_path / "s").rglob("results.json"))
    assert not list((tmp_path / "s").rglob("encoded*.bin"))
    monkeypatch.setenv("JEPSEN_TPU_NO_NATIVE", "1")
    assert cli.main(argv) == 1
    assert len(python_loads) == 3
    assert len(list((tmp_path / "s").rglob("results.json"))) == 3
    monkeypatch.setenv("PATH", path)

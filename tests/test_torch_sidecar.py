"""The port's encoded sidecar cache (jepsen_tpu_torch/store.py's
save_encoded / load_encoded, and ingest.encode_run_dir's order: cache,
native encoder, Python encoder) against the reference's, on the CPU.

- Bytes: for one run dir, the sidecar each package writes with the same
  dialect (Python's writer, with JEPSEN_TPU_NATIVE_INGEST=0, or the
  native encoder's) is the same file, in v1 and the dispatch-shaped v2,
  for list-append and (v1 only) rw-register runs; and each package
  reads the other's to the encoding it would have made itself.
- The v1 -> v2 upgrade in place, with its `sidecar_upgrades` counter and
  `cache_rebuild` event; a stale key (a touched or grown history) and a
  corrupt magic miss; JEPSEN_TPU_ENCODE_CACHE_WRITE=0 reads and never
  writes; JEPSEN_TPU_ENCODE_CACHE=0 neither reads nor writes.
- Whole sweeps: `analyze-store --checker append|wr` cold (no sidecars),
  warm (the package's own) and warmed by the reference's CLI, against
  the reference CLI with its defaults (native encoder on, cache on), on
  one path in turn (tests/test_torch_stored.py's `in_turn`): verdicts,
  results files and journal lines equal, and so are the encoder's
  counters in metrics.json (cache_hits, cache_misses, native_fallback*,
  sidecar_upgrades, warm_copy_bytes). The reference dispatches on one
  device, as the port does (the tests' eight virtual CPU devices would
  take its buckets off the warm views path).

Every sidecar is written into the test's own tmp_path store.

Tolerance: exact (bytes, integer arrays, counters)."""

import json
import os

import pytest

import jepsen_tpu.ingest as r_ingest
import jepsen_tpu.obs.events as r_events
import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu.store as r_store
import jepsen_tpu.trace as r_trace
from jepsen_tpu_torch import ingest, store, trace
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.obs import events
from test_torch_cli import ref_main, reference_env  # noqa: F401
from test_torch_native_encode import DECLINED, same_append, same_wr, \
    write_run
from test_torch_stored import assert_same, in_turn

PKGS = {"port": (ingest, store, trace, events),
        "ref": (r_ingest, r_store, r_trace, r_events)}
SAME = {"append": same_append, "wr": same_wr}


def run_dir(tmp_path, checker: str):
    """One run of `checker`'s shape, with anomalies for the witnesses."""
    if checker == "append":
        (d,) = synth.write_synth_run_store(tmp_path / "s", B=1, T=90, K=5,
                                           bad_every=1)
    else:
        (d,) = synth.write_wr_run_store(tmp_path / "s", B=1, T=90, K=5,
                                        bad_every=1)
    return d


def sidecars(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.glob("encoded*.bin"))}


def fresh_encode(pkg: str, d, checker: str):
    """`pkg`'s encode_run_dir of d with the cache off: what a sidecar
    must load back to."""
    os.environ["JEPSEN_TPU_ENCODE_CACHE"] = "0"
    try:
        return PKGS[pkg][0].encode_run_dir(d, checker)
    finally:
        del os.environ["JEPSEN_TPU_ENCODE_CACHE"]


CASES = [("append", "python", 1), ("append", "python", 2),
         ("append", "native", 1), ("append", "native", 2),
         ("wr", "python", 1), ("wr", "native", 1)]


@pytest.fixture
def cache_env(monkeypatch):
    for g in ("JEPSEN_TPU_ENCODE_CACHE", "JEPSEN_TPU_ENCODE_CACHE_WRITE",
              "JEPSEN_TPU_SIDECAR_V2", "JEPSEN_TPU_NATIVE_INGEST",
              "JEPSEN_TPU_NO_NATIVE", "JEPSEN_TPU_NATIVE_LIB_DIR"):
        monkeypatch.delenv(g, raising=False)
    trace.reset()
    r_trace.reset()
    yield monkeypatch
    trace.reset()
    r_trace.reset()


def set_dialect(mp, dialect: str, version: int) -> None:
    mp.setenv("JEPSEN_TPU_NATIVE_INGEST",
              "1" if dialect == "native" else "0")
    mp.setenv("JEPSEN_TPU_SIDECAR_V2", "1" if version == 2 else "0")


@pytest.mark.parametrize("checker,dialect,version", CASES)
def test_sidecar_bytes_match_reference(checker, dialect, version,
                                       tmp_path, cache_env):
    """The same run dir, the same dialect: the same sidecar file."""
    set_dialect(cache_env, dialect, version)
    d = run_dir(tmp_path, checker)
    got = {}
    for pkg in PKGS:
        for p in d.glob("encoded*.bin"):
            p.unlink()
        enc = PKGS[pkg][0].encode_run_dir(d, checker)
        assert not getattr(enc, "warm", False)
        got[pkg] = sidecars(d)
    want = store.encoded_cache_path(d, checker).name
    assert list(got["port"]) == [want]
    assert got["port"] == got["ref"]
    # the dialects differ: Python's header holds the lean anomalies
    header = got["port"][want][16:16 + int.from_bytes(
        got["port"][want][8:16], "little")]
    assert ("anomalies" in json.loads(header)) == (dialect == "python")


@pytest.mark.parametrize("checker,dialect,version", CASES)
def test_each_package_reads_the_others_sidecar(checker, dialect, version,
                                               tmp_path, cache_env):
    set_dialect(cache_env, dialect, version)
    d = run_dir(tmp_path, checker)
    for writer, reader in (("ref", "port"), ("port", "ref")):
        for p in d.glob("encoded*.bin"):
            p.unlink()
        PKGS[writer][0].encode_run_dir(d, checker)
        warm = PKGS[reader][1].load_encoded(d, checker)
        assert warm is not None and warm.warm
        SAME[checker](warm, fresh_encode(reader, d, checker))
        SAME[checker](warm, fresh_encode(writer, d, checker))
        if version == 2:
            assert set(warm.dispatch) == {"appends", "reads",
                                          "invoke_index",
                                          "complete_index", "process"}
            assert warm.dispatch_pad == store.dispatch_pad_plan(warm)
        else:
            assert not hasattr(warm, "dispatch")


@pytest.mark.parametrize("dialect", ["python", "native"])
def test_v1_upgrades_to_v2_in_place(dialect, tmp_path, cache_env):
    """A v1 sidecar met with the v2 gate on is rewritten as v2 in place
    (the v1 file retired) and served from it; each package counts
    `sidecar_upgrades` and logs a `cache_rebuild` event, and the two
    upgrades are the same bytes."""
    got = {}
    d = run_dir(tmp_path, "append")
    for pkg, (ing, st, tr_mod, ev) in PKGS.items():
        for p in d.glob("encoded*.bin"):
            p.unlink()
        set_dialect(cache_env, dialect, 1)
        ing.encode_run_dir(d, "append")
        assert list(sidecars(d)) == ["encoded.v1.bin"]
        cache_env.setenv("JEPSEN_TPU_SIDECAR_V2", "1")
        tr = tr_mod.fresh_run(f"upgrade-{pkg}")
        (tmp_path / pkg).mkdir()
        ev.install_events(tmp_path / pkg)
        try:
            enc = st.load_encoded(d, "append")
        finally:
            ev.reset_events()
        assert enc.warm and enc.upgraded and enc.dispatch is not None
        assert tr.metrics_dict()["counters"]["sidecar_upgrades"] == 1
        kinds = [(e["event"], e["cause"]) for e in
                 map(json.loads, (tmp_path / pkg / "events.jsonl")
                     .read_text().splitlines())]
        assert kinds == [("cache_rebuild", "v1->v2 upgrade")]
        got[pkg] = sidecars(d)
        assert list(got[pkg]) == ["encoded.v2.bin"]
        same_append(enc, fresh_encode(pkg, d, "append"))
    assert got["port"] == got["ref"]


def test_stale_key_and_bad_magic_miss(tmp_path, cache_env):
    d = run_dir(tmp_path, "append")
    ingest.encode_run_dir(d, "append")
    assert store.load_encoded(d, "append") is not None
    jl = d / "history.jsonl"
    st = jl.stat()
    os.utime(jl, ns=(st.st_atime_ns, st.st_mtime_ns + 1000))
    assert store.load_encoded(d, "append") is None     # touched
    tr = trace.fresh_run("stale")
    enc = ingest.encode_run_dir(d, "append")          # re-encoded, cached
    assert not getattr(enc, "warm", False)
    assert tr.metrics_dict()["counters"]["cache_misses"] == 1
    assert store.load_encoded(d, "append") is not None
    with open(jl, "a") as f:
        f.write("\n")                                  # grown
    assert store.load_encoded(d, "append") is None
    ingest.encode_run_dir(d, "append")
    p = store.encoded_cache_path(d, "append")
    p.write_bytes(b"NOTMAGIC" + p.read_bytes()[8:])
    events.install_events(tmp_path)
    try:
        assert store.load_encoded(d, "append") is None
    finally:
        events.reset_events()
    assert "bad magic" in (tmp_path / "events.jsonl").read_text()


@pytest.mark.parametrize("checker", ["append", "wr"])
def test_read_only_and_off(checker, tmp_path, cache_env):
    """ENCODE_CACHE_WRITE=0: an existing sidecar still answers, none is
    written, and a v1 one is not upgraded; ENCODE_CACHE=0: no read and
    no write, and no cache counter."""
    d = run_dir(tmp_path, checker)
    cache_env.setenv("JEPSEN_TPU_ENCODE_CACHE_WRITE", "0")
    tr = trace.fresh_run("ro")
    ingest.encode_run_dir(d, checker)
    assert sidecars(d) == {}
    assert tr.metrics_dict()["counters"]["cache_misses"] == 1
    cache_env.setenv("JEPSEN_TPU_ENCODE_CACHE_WRITE", "1")
    cache_env.setenv("JEPSEN_TPU_SIDECAR_V2", "0")
    ingest.encode_run_dir(d, checker)
    v1 = sidecars(d)
    assert len(v1) == 1
    cache_env.setenv("JEPSEN_TPU_ENCODE_CACHE_WRITE", "0")
    cache_env.setenv("JEPSEN_TPU_SIDECAR_V2", "1")
    tr = trace.fresh_run("ro-warm")
    enc = ingest.encode_run_dir(d, checker)
    assert enc.warm and not getattr(enc, "upgraded", False)
    assert sidecars(d) == v1
    assert tr.metrics_dict()["counters"]["cache_hits"] == 1
    cache_env.setenv("JEPSEN_TPU_ENCODE_CACHE", "0")
    for p in d.glob("encoded*.bin"):
        p.unlink()
    tr = trace.fresh_run("off")
    enc = ingest.encode_run_dir(d, checker)
    assert not getattr(enc, "warm", False) and sidecars(d) == {}
    assert not any(k.startswith("cache_")
                   for k in tr.metrics_dict()["counters"])


# -- whole sweeps -------------------------------------------------------

#: Counters of the encoder and the warm pack, compared in metrics.json.
ENCODER_COUNTERS = ("cache_hits", "cache_misses", "sidecar_upgrades",
                    "warm_copy_bytes")


def encoder_counters(metrics: dict) -> dict:
    return {k: v for k, v in metrics["counters"].items()
            if k in ENCODER_COUNTERS or k.startswith("native_fallback")}


def sweep_store(base, checker: str) -> None:
    """Runs of `checker`'s shape (every 3rd anomalous, two lengths, so a
    bucket holds views of two pad geometries), a run the native side
    declines, and a txn-less run (the stored checker)."""
    if checker == "append":
        synth.write_synth_run_store(base, B=4, T=120, K=6, bad_every=3)
        synth.write_synth_run_store(base, B=2, T=200, K=6, bad_every=2,
                                    name="longer")
    else:
        synth.write_wr_run_store(base, B=4, T=60, K=4, bad_every=3)
        synth.write_wr_run_store(base, B=2, T=90, K=4, bad_every=2,
                                 name="longer")
    write_run(base / "odd", DECLINED[checker], "run-00000")
    write_run(base / "odd", [{"type": "invoke", "process": 0, "f": "read",
                              "value": None},
                             {"type": "ok", "process": 0, "f": "read",
                              "value": 3}], "run-00001")


@pytest.fixture
def sweep_env(reference_env, monkeypatch):  # noqa: F811
    import jax
    mesh = ref_parallel.make_mesh(jax.devices()[:1])
    monkeypatch.setattr(ref_parallel, "make_mesh", lambda *a, **k: mesh)
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    for g in ("JEPSEN_TPU_ENCODE_CACHE", "JEPSEN_TPU_ENCODE_CACHE_WRITE",
              "JEPSEN_TPU_SIDECAR_V2", "JEPSEN_TPU_NATIVE_INGEST",
              "JEPSEN_TPU_NO_NATIVE", "JEPSEN_TPU_TRACE"):
        monkeypatch.delenv(g, raising=False)


@pytest.mark.parametrize("checker", ["append", "wr"])
@pytest.mark.parametrize("warmth", ["cold", "warm", "ref-warmed",
                                    "v1-upgraded", "v1-warm"])
def test_sweep_matches_reference(checker, warmth, tmp_path, sweep_env,
                                 capsys, monkeypatch):
    """`cold`: no sidecars; `warm`: the package's own, from a first
    sweep; `ref-warmed`: the reference CLI's; `v1-upgraded`: the
    reference's v1 sidecars (JEPSEN_TPU_SIDECAR_V2=0), upgraded by the
    measured sweep; `v1-warm`: v1 throughout, so a warm bucket is
    repacked from the cache and counts `warm_copy_bytes`."""
    pristine = tmp_path / "pristine"
    sweep_store(pristine, checker)
    argv = ["--checker", checker]
    grabbed = []

    def grab(s):
        grabbed.append(json.loads((s / "metrics.json").read_text()))

    def forget(s):
        # the warm-up's verdicts and summary lines out of the comparison
        capsys.readouterr()
        for p in list(s.rglob("results.*")) + list(s.rglob(".sweep-*")) \
                + [s / "verdicts.jsonl"]:
            p.unlink()

    def ref_sweep(s, v2: bool = True):
        with monkeypatch.context() as mp:
            mp.setenv("JEPSEN_TPU_SIDECAR_V2", "1" if v2 else "0")
            assert ref_main(["analyze-store", "--store", str(s),
                             *argv]) == 1

    if warmth == "v1-warm":
        monkeypatch.setenv("JEPSEN_TPU_SIDECAR_V2", "0")
    pre = {"cold": [], "warm": [(argv, None), forget],
           "v1-warm": [(argv, None), forget],
           "ref-warmed": [ref_sweep, forget],
           "v1-upgraded": [lambda s: ref_sweep(s, v2=False), forget]
           }[warmth]
    got = in_turn(tmp_path, pristine, pre + [(argv, None), grab], capsys)
    assert_same(got)
    rcs, snap, out = got["port"]
    assert rcs[-1] == 1 and len(out) == 8
    ref, port = (encoder_counters(m) for m in grabbed)
    assert ref == port
    assert "native_fallback" not in port
    cached = 8 - port.get("cache_misses", 0)
    if warmth == "cold":
        assert port["cache_misses"] == 8 and "cache_hits" not in port
    else:
        assert port["cache_hits"] == cached >= 6
    if warmth == "v1-upgraded" and checker == "append":
        assert port["sidecar_upgrades"] == cached
    else:
        assert "sidecar_upgrades" not in port
    if warmth == "v1-warm" and checker == "append":
        assert port["warm_copy_bytes"] > 0
    else:
        assert "warm_copy_bytes" not in port     # the views path

"""Two faults of the port's CLI, each held to the reference CLI on the
CPU, on one path in turn (tests/test_torch_stored.py's `in_turn`):

- JEPSEN_TPU_FRONTIER sizes the register sweep's bounded frontier (the
  reference's `Linearizable` reads it when `frontier` is None). With it
  at 16, eight concurrent CAS-register histories past the dense grid's
  budgets are all predicted to overflow the frontier and go to the WGL
  oracle in both packages; the port once kept 512 and answered seven
  of them on the device ("tpu-jit"). Results and, under
  JEPSEN_TPU_KERNEL_STATS=1, analytics.jsonl must equal the
  reference's.
- `analyze-store` takes `--trace/--no-trace` and
  `--jax-profile/--no-jax-profile` and exports them to JEPSEN_TPU_TRACE
  and JEPSEN_TPU_JAX_PROFILE before the sweep; the port once refused
  them as usage errors (exit 254). Both CLIs must give the same exit
  code and leave the same files: per-run results and markers, the
  journal, and the store's own telemetry files by name (the profile
  directory is `jax-profile/` in the reference and `torch-profile/` in
  the port).

Tolerance: exact."""

import json

import pytest

import jepsen_tpu.gates as ref_gates
from jepsen_tpu_torch import gates, trace
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.knossos import synth as ksynth
from test_torch_cli import reference_env  # noqa: F401
from test_torch_stored import assert_same, in_turn, write_run

NEW_GATES = ("JEPSEN_TPU_FRONTIER", "JEPSEN_TPU_NATIVE_INGEST",
             "JEPSEN_TPU_NO_NATIVE", "JEPSEN_TPU_NATIVE_LIB_DIR",
             "JEPSEN_TPU_ENCODE_CACHE", "JEPSEN_TPU_ENCODE_CACHE_WRITE",
             "JEPSEN_TPU_SIDECAR_V2")
RAWS = [None, "", "0", "1", "yes", "false", " 2.5 ", "abc", "-1", "16",
        "0.0", "  ", "/some/dir"]


@pytest.mark.parametrize("name", NEW_GATES)
def test_gate_matches_reference(name):
    mine, ref = gates.GATES[name], ref_gates.GATES[name]
    assert (mine.kind, mine.default) == (ref.kind, ref.default)
    for raw in RAWS:
        assert mine.parse(raw) == ref.parse(raw), raw


def test_linearizable_reads_the_frontier_gate(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_FRONTIER", raising=False)
    assert Linearizable().frontier == 512
    monkeypatch.setenv("JEPSEN_TPU_FRONTIER", "16")
    assert Linearizable().frontier == 16
    assert Linearizable(frontier=64).frontier == 64


@pytest.fixture
def env(reference_env, monkeypatch):  # noqa: F811
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    for g in ("JEPSEN_TPU_TRACE", "JEPSEN_TPU_JAX_PROFILE",
              "JEPSEN_TPU_KERNEL_STATS", "JEPSEN_TPU_FRONTIER"):
        # set, then unset: monkeypatch records the gate either way, so
        # what `--trace`/`--jax-profile` export is undone after the
        # test and never reaches a later test's subprocesses
        monkeypatch.setenv(g, "")
        monkeypatch.delenv(g)
    trace.reset()
    yield monkeypatch
    trace.reset()


def test_frontier_gate_register_sweep_matches_reference(tmp_path, env,
                                                        capsys):
    env.setenv("JEPSEN_TPU_FRONTIER", "16")
    env.setenv("JEPSEN_TPU_KERNEL_STATS", "1")
    pristine = tmp_path / "pristine"
    hists = ksynth.synth_register_batch(B=8, n_ops=256, n_procs=20,
                                        n_values=10_000, info_prob=0.005,
                                        seed=11, max_pending=8)
    for i, h in enumerate(hists):
        write_run(pristine / "register" / f"run-{i:05d}", h)
    ledgers = []
    got = in_turn(tmp_path, pristine, [
        (["--checker", "register"], None),
        lambda s: ledgers.append((s / "analytics.jsonl").read_bytes())],
        capsys)
    assert_same(got)
    assert ledgers[0] == ledgers[1]
    rcs, snap, out = got["port"]
    analyzers = []
    for k, v in snap.items():
        if k.endswith("results.json"):
            for r in json.loads(v)["results"].values():
                analyzers.append(r.get("analyzer"))
    assert analyzers == ["wgl"] * 8
    recs = [json.loads(ln) for ln in ledgers[1].decode().splitlines()]
    assert len(recs) == 8 and all(r["engines"] == ["wgl-native"]
                                  for r in recs)


#: The store's top-level files each package leaves, the profile
#: directory by the port's name.
PROFILE_DIRS = {"jax-profile": "torch-profile"}


@pytest.mark.parametrize("flag", ["--trace", "--no-trace", "--jax-profile",
                                  "--no-jax-profile"])
def test_trace_flags_match_reference(flag, tmp_path, env, capsys):
    pristine = tmp_path / "pristine"
    synth.write_synth_run_store(pristine, B=3, T=30, K=4, bad_every=2)
    tops = []
    got = in_turn(tmp_path, pristine, [
        (["--checker", "append", flag], None),
        lambda s: tops.append(sorted(
            PROFILE_DIRS.get(p.name, p.name) for p in s.iterdir()))],
        capsys)
    assert_same(got)
    assert got["port"][0] == [1]
    assert tops[0] == tops[1]
    written = set(tops[1])
    assert ("trace.json" in written) == (flag != "--no-trace")
    assert ("torch-profile" in written) == (flag == "--jax-profile")
    assert {"events.jsonl", "verdicts.jsonl"} <= written

"""The port's native per-key split (`native_lib.split_key_ids`,
`independent.subhistories_path`) against the reference's.

Every case of tests/test_native_split.py — targeted edge cases
(empty-string keys, single-op keys, :info-only keys, nemesis
interleavings, non-lifting histories, keys the native pass declines)
and the fuzzed lifted-register corpus — goes through both packages'
`subhistories_path` on the same file, and the per-key lists must be
equal, key order included, and equal to the port's
`subhistories(relift_history(h))`. Where the reference's native
splitter accepts a file the port's must too, and where it declines so
must the port's. The gate `JEPSEN_TPU_NATIVE_SPLIT=0` pins the Python
path; `stats` counts which path ran.
"""

from __future__ import annotations

import json
import random

import pytest

from jepsen_tpu import independent as ref_independent
from jepsen_tpu import native_lib as ref_native_lib
from jepsen_tpu_torch import independent, native_lib

pytestmark = pytest.mark.skipif(
    ref_native_lib.hist_lib() is None,
    reason="the reference's native hist encoder is unavailable (no g++?)")


def write_hist(tmp_path, ops, name="h"):
    p = tmp_path / f"{name}.jsonl"
    p.write_text("\n".join(json.dumps(o) for o in ops) + "\n"
                 if ops else "")
    return p


def load(p):
    lines = [ln for ln in p.read_text().splitlines() if ln.strip()]
    return json.loads("[" + ",".join(lines) + "]") if lines else []


def reg_op(ty, proc, f, key, val, **extra):
    return {"type": ty, "process": proc, "f": f, "value": [key, val],
            **extra}


def assert_split_parity(tmp_path, ops, name="h", expect_native=True):
    """The port's subhistories_path equals the reference's and the
    port's pure relift+subhistories walk; the port's native splitter
    accepts the file exactly when the reference's does."""
    p = write_hist(tmp_path, ops, name)
    hist = load(p)
    mine, ref = native_lib.split_key_ids(p), ref_native_lib.split_key_ids(p)
    assert (mine is None) == (ref is None), name
    if mine is not None:
        assert mine[0] == ref[0] and mine[1].tolist() == ref[1].tolist()
    assert (mine is not None) == expect_native, name
    stats: dict = {}
    nat = independent.subhistories_path(hist, p, stats=stats)
    assert stats == {"native" if expect_native else "python": 1}
    want = ref_independent.subhistories_path(hist, p)
    pure = independent.subhistories(independent.relift_history(hist))
    assert list(nat) == list(want) == list(pure), name
    for k in want:
        assert nat[k] == want[k] == pure[k], (name, k)
    return nat


def basic():
    ops = []
    for i in range(30):
        k = i % 3
        ops.append(reg_op("invoke", i % 4, "read", k, None, index=2 * i))
        ops.append(reg_op("ok", i % 4, "read", k, i, index=2 * i + 1))
    return ops


def nemesis():
    return [
        {"type": "info", "process": "nemesis", "f": "start", "value": None},
        reg_op("invoke", 0, "read", "a", None),
        reg_op("ok", 0, "read", "a", 1),
        {"type": "info", "process": "nemesis", "f": "stop",
         "value": ["not", "lifted"]},
        reg_op("invoke", 1, "write", "b", 2),
        reg_op("ok", 1, "write", "b", 2),
    ]


def edge_keys():
    return [reg_op("invoke", 0, "read", "", None),
            reg_op("ok", 0, "read", "", 7),
            reg_op("invoke", 1, "write", "lonely", 3)]


def info_only():
    return [reg_op("invoke", 0, "read", 1, None),
            reg_op("ok", 0, "read", 1, 5),
            reg_op("invoke", 2, "cas", 99, [1, 2]),
            reg_op("info", 2, "cas", 99, None)]


def scalar():
    return [{"type": "invoke", "process": 0, "f": "read", "value": None},
            {"type": "ok", "process": 0, "f": "read", "value": 3},
            {"type": "invoke", "process": 1, "f": "write", "value": 4},
            {"type": "ok", "process": 1, "f": "write", "value": 4}]


def cas_only():
    return [{"type": "invoke", "process": 0, "f": "cas", "value": [1, 2]},
            {"type": "ok", "process": 0, "f": "cas", "value": [1, 2]}]


def mixed():
    return [reg_op("invoke", 0, "read", 1, None),
            reg_op("ok", 0, "read", 1, 0),
            reg_op("invoke", 1, "read", "1", None),
            reg_op("ok", 1, "read", "1", 0),
            reg_op("invoke", 2, "write", -7, 3)]


#: (name, ops, whether the native pass accepts the file, the keys)
CASES = [
    ("basic", basic(), True, [0, 1, 2]),
    ("nemesis", nemesis(), True, ["a", "b"]),
    ("edge-keys", edge_keys(), True, ["", "lonely"]),
    ("info-only", info_only(), True, [1, 99]),
    ("scalar", scalar(), True, []),
    ("cas-only", cas_only(), True, []),
    ("mixed", mixed(), True, [1, "1", -7]),
    ("floatkey", [reg_op("invoke", 0, "read", 1.5, None),
                  reg_op("ok", 0, "read", 1.5, 2)], False, [1.5]),
    ("boolkey", [reg_op("invoke", 0, "read", True, None),
                 reg_op("ok", 0, "read", True, 2)], False, [True]),
    ("bigkey", [reg_op("invoke", 0, "read", 2 ** 70, None),
                reg_op("ok", 0, "read", 2 ** 70, 2)], False, [2 ** 70]),
]


@pytest.mark.parametrize("name,ops,native,keys", CASES,
                         ids=[c[0] for c in CASES])
def test_split_parity(tmp_path, name, ops, native, keys):
    subs = assert_split_parity(tmp_path, ops, name, expect_native=native)
    assert list(subs) == keys


def test_nemesis_ops_land_in_every_key(tmp_path):
    subs = assert_split_parity(tmp_path, nemesis(), "nemesis-prefix")
    assert [o["f"] for o in subs["b"][:2]] == ["start", "stop"]


def test_empty_history(tmp_path):
    p = write_hist(tmp_path, [], "empty")
    assert independent.subhistories_path([], p) == {} \
        == ref_independent.subhistories_path([], p)


def test_gate_env_pins_python_path(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_NATIVE_SPLIT", "0")
    assert not independent.native_split_enabled()
    calls = []
    orig = native_lib.split_key_ids
    monkeypatch.setattr(native_lib, "split_key_ids",
                        lambda p: calls.append(p) or orig(p))
    p = write_hist(tmp_path, basic(), "gated")
    hist = load(p)
    stats: dict = {}
    got = independent.subhistories_path(hist, p, stats=stats)
    assert not calls and stats == {"python": 1}
    assert got == ref_independent.subhistories_path(hist, p)


def test_gate_defaults_on(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_NATIVE_SPLIT", raising=False)
    assert independent.native_split_enabled() \
        == ref_independent.native_split_enabled() is True


def test_misaligned_history_falls_back(tmp_path):
    """A caller holding another history than the file (edited,
    truncated) gets the Python answer, not mixed-up ids."""
    ops = [reg_op("invoke", 0, "read", 0, None),
           reg_op("ok", 0, "read", 0, 1),
           reg_op("invoke", 1, "read", 1, None),
           reg_op("ok", 1, "read", 1, 2)]
    p = write_hist(tmp_path, ops, "misaligned")
    hist = load(p)[:2]
    stats: dict = {}
    nat = independent.subhistories_path(hist, p, stats=stats)
    assert stats == {"python": 1}
    assert nat == independent.subhistories(
        independent.relift_history(hist)) \
        == ref_independent.subhistories_path(hist, p)


def test_declined_file_falls_back_and_counts(tmp_path):
    from jepsen_tpu_torch import trace
    tr = trace.fresh_run("split")
    p = write_hist(tmp_path, CASES[7][1], "declined")
    stats: dict = {}
    independent.subhistories_path(load(p), p, stats=stats)
    assert stats == {"python": 1}
    assert tr.counter("native_fallback.split_key_ids").value == 1
    assert tr.counter("split.python").value == 1


def test_planner_declines_small_histories(tmp_path, monkeypatch):
    """The planner may only DECLINE the native path (its split_min_ops
    threshold), never force it past the gate."""
    from jepsen_tpu_torch import planner

    class Declining:
        def split_native(self, n_ops):
            return n_ops >= 10 ** 6

    monkeypatch.setattr(planner, "get", lambda: Declining())
    p = write_hist(tmp_path, basic(), "planned")
    stats: dict = {}
    got = independent.subhistories_path(load(p), p, stats=stats)
    assert stats == {"python": 1}
    assert got == ref_independent.subhistories_path(load(p), p)


def lifted_register_history(rng, keys, per_key, nemesis_p=0.1):
    """A lifted multi-key register run, interleaved round-robin, with
    random nemesis ops (the reference test's construction, on the
    port's synth)."""
    from jepsen_tpu_torch.checker.knossos import synth as ksynth

    streams = []
    for j, k in enumerate(keys):
        h = ksynth.synth_register_history(
            n_ops=per_key, n_procs=3, n_values=6,
            info_prob=0.05, seed=rng.randrange(1 << 30), max_pending=4)
        streams.append([{"type": o["type"], "process": o["process"] + j * 3,
                         "f": o["f"], "value": [k, o.get("value")]}
                        for o in h])
    out = []
    live = [iter(s) for s in streams]
    while live:
        nxt = []
        for it in live:
            o = next(it, None)
            if o is None:
                continue
            if rng.random() < nemesis_p:
                out.append({"type": "info", "process": "nemesis",
                            "f": rng.choice(["kill", "heal"]),
                            "value": None})
            out.append(o)
            nxt.append(it)
        live = nxt
    return [{**o, "index": i} for i, o in enumerate(out)]


def test_fuzz_split_parity(tmp_path):
    rng = random.Random(20260803)
    for trial in range(12):
        keys = rng.choice([
            [0, 1, 2],
            ["a", "b", "", "d"],
            list(range(rng.randrange(1, 9))),
            ["k1", 7, "k2", -3],
        ]) or [0]
        ops = lifted_register_history(
            rng, keys, per_key=rng.choice([1, 6, 20]),
            nemesis_p=rng.choice([0.0, 0.15]))
        assert_split_parity(tmp_path, ops, f"fuzz{trial}")


def test_fuzz_txn_histories_never_lift(tmp_path):
    """Append/wr txn corpora (list-of-mops values) trip the lift
    heuristic on neither package."""
    from test_fuzz_differential import rand_append_history

    rng = random.Random(7)
    for trial in range(4):
        ops = rand_append_history(rng, 40, 6, 3)
        assert assert_split_parity(tmp_path, ops, f"txn{trial}") == {}

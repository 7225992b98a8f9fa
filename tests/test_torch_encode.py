"""The port's host-side copies against the JAX package's originals: the
encoder, verdict rendering, EDN, the store walk and journal, and the
bucketing — the same inputs through both, compared exactly."""

import json
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jepsen_tpu import edn as r_edn
from jepsen_tpu import store as r_store
from jepsen_tpu.checker import elle as r_elle
from jepsen_tpu.checker.elle import encode as r_encode
from jepsen_tpu.checker.elle import kernels as RK
from jepsen_tpu.parallel import bucket_by_length as r_bucket_by_length
from jepsen_tpu_torch import convert, edn, parallel, store
from jepsen_tpu_torch.checker import elle
from jepsen_tpu_torch.checker.elle import encode, kernels as K, synth

import test_elle_append as fx

HISTORIES = {
    "g0": fx.g0_history,
    "g1c": fx.g1c_history,
    "g_single": fx.g_single_history,
    "g2": fx.g2_history,
    "synth": lambda: synth.synth_append_history(80, 5, seed=3, g1c=True),
    "corrupt": lambda: fx.random_history(random.Random(5), 40, 4,
                                         corrupt=6),
    "aborted": lambda: [
        {"type": "invoke", "process": 0, "f": "txn",
         "value": [["append", "x", 1]]},
        {"type": "fail", "process": 0, "f": "txn",
         "value": [["append", "x", 1]]},
        {"type": "invoke", "process": 1, "f": "txn",
         "value": [["append", "x", 2]]},
        {"type": "invoke", "process": 2, "f": "txn",
         "value": [["r", "x", None]]},
        {"type": "info", "process": 1, "f": "txn", "value": None},
        {"type": "ok", "process": 2, "f": "txn",
         "value": [["r", "x", [1, 2, 3]]]},
    ],
    "intermediate": lambda: fx.seq_history(
        ([["append", "x", 1], ["append", "x", 2]],
         [["append", "x", 1], ["append", "x", 2]]),
        ([["r", "x", None]], [["r", "x", [1]]]),
        ([["append", "x", 1]], [["append", "x", 1]]),
        ([["r", "x", None], ["append", "x", 7], ["r", "x", None]],
         [["r", "x", [1, 2]], ["append", "x", 7], ["r", "x", [1]]])),
    "empty": lambda: [],
}

ARRAYS = ("appends", "reads", "status", "process", "invoke_index",
          "complete_index", "op_index")


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_encoder_matches_reference(name):
    ref = r_encode.encode_history(HISTORIES[name]())
    got = encode.encode_history(HISTORIES[name]())
    assert (got.n, got.n_keys, got.max_pos) == (ref.n, ref.n_keys,
                                                ref.max_pos)
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.anomalies == ref.anomalies
    assert got.key_names == ref.key_names
    assert encode.lean_anomalies(got) == r_encode.lean_anomalies(ref)


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_rendered_verdict_matches_reference(name):
    ref = r_encode.encode_history(HISTORIES[name]())
    enc = convert.encoded_from_arrays(
        **{f: getattr(ref, f) for f in convert.ENCODED_FIELDS})
    enc.txn_ops = ref.txn_ops
    cycles = {}
    if enc.n:
        batch = K.batch_to_device(K.pack_batch([enc]), torch.device("cpu"))
        cycles = K.flags_to_names(K.check_batch_device(batch).tolist()[0])
        assert cycles == RK.check_encoded_batch([ref])[0]
    want = r_elle.render_verdict(ref, cycles,
                                 r_elle.AppendChecker().prohibited)
    assert elle.render_verdict(enc, cycles, elle.APPEND_PROHIBITED) == want
    assert elle.APPEND_PROHIBITED == r_elle.AppendChecker().prohibited


def test_flag_names_closure_steps_and_pad_to_match():
    for w in range(1 << 5):
        assert K.flags_to_names(w) == RK.flags_to_names(w)
    for n in (0, 1, 2, 3, 127, 128, 129, 5000, 32768):
        assert K.closure_steps(n) == RK.closure_steps(n)
        assert K.pad_to(n, 128) == RK.pad_to(n, 128)


@pytest.mark.parametrize("seed", [1, 3])
def test_bucket_by_length_matches_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = [SimpleNamespace(n=int(n)) for n in rng.integers(1, 3000, 60)]
    for budget in (1 << 20, 1 << 24, 1 << 27):
        assert parallel.bucket_by_length(sizes, budget_cells=budget) == \
            r_bucket_by_length(sizes, budget_cells=budget)


EDN_VALUES = [
    {"valid?": False, "anomaly-types": ["G1c"], "anomalies": {"G1c": True},
     "txn-count": 3, "key-count": 2, "checker": "append"},
    {"valid?": "unknown", "x": [1.5, None, True, "a b", "valid"],
     "s": frozenset({1, 2}), "nested": {"k": [{"y": -3}]}},
]


@pytest.mark.parametrize("i", range(len(EDN_VALUES)))
def test_results_edn_matches_reference(i):
    v = EDN_VALUES[i]
    got = edn.dumps(store._results_to_edn(v))
    assert got == r_edn.dumps(r_store._results_to_edn(v))
    assert edn.loads(got) == r_edn.loads(got)
    text = '{:type :ok, :value [[:append 1 2] [:r 1 [2]]], :index 3} #{1 2}'
    assert edn.loads_all(text) == r_edn.loads_all(text)


def test_store_walk_and_journal_match_reference(tmp_path):
    base = tmp_path / "store"
    for name, run in [("b", "2"), ("a", "1"), ("a", "0"), ("c", "x")]:
        (base / name / run).mkdir(parents=True)
    os.symlink(base / "a" / "1", base / "a" / "latest")
    os.symlink(base / "a" / "1", base / "latest")
    assert list(store.Store(base).iter_run_dirs()) == \
        list(r_store.Store(base).iter_run_dirs())
    res = {"valid?": False, "anomaly-types": ["G1c"]}
    for mod, fname in ((store, "port.jsonl"), (r_store, "ref.jsonl")):
        j = mod.VerdictJournal(base / fname, base=base)
        for d in mod.Store(base).iter_run_dirs():
            assert j.record(d, "append", res)
        j.close()
    port = (base / "port.jsonl").read_text()
    assert port == (base / "ref.jsonl").read_text()
    assert json.loads(port.splitlines()[0])["dir"] == "a/0"


def test_journal_seals_a_torn_tail(tmp_path):
    p = tmp_path / "verdicts.jsonl"
    p.write_text('{"dir": "a/0", "checker": "append", "valid?": tr')
    j = store.VerdictJournal(p, base=tmp_path)
    assert j.record(tmp_path / "a" / "1", "append", {"valid?": True})
    j.close()
    lines = p.read_text().splitlines()
    assert json.loads(lines[-1]) == {"dir": "a/1", "checker": "append",
                                     "valid?": True}


def test_load_history_dir_reads_jsonl_and_edn(tmp_path):
    hist = HISTORIES["g1c"]()
    (tmp_path / "j").mkdir()
    (tmp_path / "j" / "history.jsonl").write_text(
        "".join(json.dumps(o) + "\n" for o in hist))
    (tmp_path / "e").mkdir()
    from jepsen_tpu import history as r_history
    (tmp_path / "e" / "history.edn").write_text(
        r_history.history_to_edn(hist))
    for d in ("j", "e"):
        assert store.load_history_dir(tmp_path / d) == \
            r_store.load_history_dir(tmp_path / d)
    with pytest.raises(FileNotFoundError):
        store.load_history_dir(tmp_path)

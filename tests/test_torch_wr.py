"""The port's rw-register path (jepsen_tpu_torch.checker.elle.wr and the
edge-matrix entries of kernels) against the JAX package's, on the CPU,
over the same seeded histories and edge lists.

Tolerance: exact — encoded fields, anomaly witnesses and their order,
bool edge matrices, int32 flag words, verdict dicts."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu.checker.elle import kernels as RK
from jepsen_tpu.checker.elle import wr as RW
from jepsen_tpu_torch import convert
from jepsen_tpu_torch.checker.elle import kernels as K
from jepsen_tpu_torch.checker.elle import synth, wr
from test_fuzz_differential import rand_wr_history

CPU = torch.device("cpu")
FLAGS = [{}, {"sequential_keys": True}, {"linearizable_keys": True},
         {"wfr_keys": True}]


@pytest.fixture(autouse=True)
def _private_aot_cache(monkeypatch, tmp_path):
    # the reference's executable cache stays out of the shared home dir
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path))


def fuzz_history(seed: int) -> list[dict]:
    """A corrupted rw-register history: wrong reads (G1a, phantom,
    cyclic versions...), crashed and failed txns."""
    rng = random.Random(seed)
    return rand_wr_history(rng, rng.choice([30, 120]), rng.choice([2, 6]),
                           rng.choice([1, 6]))


def assert_same_encoding(got, want):
    assert got.n == want.n and got.key_count == want.key_count
    assert got.edges == want.edges
    for f in ("status", "process", "invoke_index", "complete_index"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert list(got.anomalies.items()) == list(want.anomalies.items())
    assert got.txn_ops == want.txn_ops


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "none")
@pytest.mark.parametrize("seed", range(8))
def test_encode_wr_history_equals_reference(seed, flags):
    hist = fuzz_history(seed)
    got = wr.encode_wr_history(hist, **flags)
    want = RW.encode_wr_history(hist, **flags)
    assert_same_encoding(got, want)
    assert list(wr.lean_wr_anomalies(got).items()) == \
        list(RW.lean_wr_anomalies(want).items())
    cycles = {"G2-item": True} if seed % 2 else {}
    prohibited = RW.WrChecker().prohibited
    assert wr.render_wr_verdict(got, cycles, wr.WR_PROHIBITED) == \
        RW.render_wr_verdict(want, cycles, prohibited)


def test_prohibited_set_and_expansion_equal_reference():
    assert wr.WR_PROHIBITED == RW.WrChecker().prohibited
    assert wr.ANOMALY_EXPANSION == RW.ANOMALY_EXPANSION
    assert wr.ALWAYS_INVALID == RW.ALWAYS_INVALID
    assert wr.to_edge_dict(wr.WrEncoded()).keys() == \
        RW.to_edge_dict(RW.WrEncoded()).keys()


def test_wr_encoded_carries_across():
    want = wr.encode_wr_history(fuzz_history(3))
    ref = RW.encode_wr_history(fuzz_history(3))
    got = convert.wr_encoded_from_fields(
        **{f: getattr(ref, f) for f in convert.WR_ENCODED_FIELDS})
    want.txn_ops = []
    assert_same_encoding(got, want)


@pytest.mark.parametrize("write_skew", [False, True])
def test_synth_wr_runs(write_skew):
    """Serial runs are valid; the write-skew pair is a G2-item — by the
    reference's own host oracle."""
    hist = synth.wr_run_ops(400, 8, seed=write_skew, write_skew=write_skew)
    ref = RW.encode_wr_history(hist)
    assert ref.anomalies == {}
    cycles = RW.cycle_anomalies_cpu(ref)
    assert set(cycles) == ({"G2-item"} if write_skew else set())
    assert ref.n == 400 + 2 * write_skew


def edge_dicts(seed: int, n: int = 5) -> list[dict]:
    """Edge dicts of random shape: wr encodings of fuzz histories and
    random ww/wr/rw edge sets with self-loops and parallel edges."""
    out = [RW.to_edge_dict(RW.encode_wr_history(fuzz_history(seed * 10 + i)))
           for i in range(n - 2)]
    rng = np.random.default_rng(seed)
    for _ in range(2):
        m = int(rng.integers(5, 200))
        e = int(rng.integers(0, 3 * m))
        out.append({
            "n": m,
            "edges": [(int(s), int(d), int(c)) for s, d, c in zip(
                rng.integers(0, m, e), rng.integers(0, m, e),
                rng.integers(0, 3, e))],
            "invoke_index": rng.permutation(2 * m)[:m].astype(np.int64),
            "complete_index": (2 * m + rng.integers(0, 2 * m, m)),
            "process": rng.integers(-1, 4, m).astype(np.int32)})
    return out


@pytest.mark.parametrize("seed", range(3))
def test_packed_edge_matrices_equal_reference(seed):
    hists = edge_dicts(seed)
    want = RK.pack_edge_matrices(hists)
    got = K.edge_batch_to_device(K.pack_edge_matrices(hists), CPU)
    assert got["T"] == want["T"]
    for k in ("ww", "wr", "rw", "invoke_index", "complete_index",
              "process", "n_txns"):
        assert np.array_equal(got[k].numpy(), want[k]), k


def test_pack_edge_matrices_rejects_bad_edges():
    good = {"n": 3, "invoke_index": [0, 1, 2], "complete_index": [3, 4, 5],
            "process": [0, 1, 2]}
    with pytest.raises(ValueError, match="not ww, wr or rw"):
        K.pack_edge_matrices([{**good, "edges": [(0, 1, 3)]}])
    with pytest.raises(ValueError, match="leaves its 3 txns"):
        K.pack_edge_matrices([{**good, "edges": [(0, 3, 0)]}])
    with pytest.raises(ValueError, match="leaves its 3 txns"):
        K.pack_edge_matrices([{**good, "edges": [(-1, 2, 1)]}])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("classify", [True, False])
@pytest.mark.parametrize("realtime,process_order",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_check_edge_batch_equals_reference(classify, realtime,
                                           process_order, fused):
    hists = edge_dicts(7, n=6)
    kw = dict(realtime=realtime, process_order=process_order,
              classify=classify)
    want = RK.check_edge_batch(hists, fused=fused, **kw)
    got = K.check_edge_batch(hists, CPU, fused=fused, **kw)
    assert [list(g.items()) for g in got] == [list(w.items()) for w in want]
    assert any(want)                      # some history is cyclic


@pytest.mark.parametrize("budget_cells", [1 << 27, 3 * 128 * 128])
def test_check_edge_batch_bucketed_equals_reference(budget_cells):
    hists = edge_dicts(11, n=8)
    want = RK.check_edge_batch_bucketed(hists, budget_cells=budget_cells)
    log: list = []
    got = K.check_edge_batch_bucketed(hists, CPU, budget_cells=budget_cells,
                                      bucket_log=log)
    assert got == want
    assert sum(b["histories"] for b in log) == len(hists)
    if budget_cells < 1 << 27:
        assert len(log) > 1
    for b in log:
        assert b["histories"] * b["t_pad"] ** 2 <= budget_cells
        assert b["closure_rounds"] and b["seconds"] > 0


def test_check_edge_batch_defaults_to_cuda(monkeypatch):
    from jepsen_tpu_torch.devices import DeviceUnavailable
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        K.check_edge_batch(edge_dicts(1, n=3))
    assert K.check_edge_batch([], None) == []

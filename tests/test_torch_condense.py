"""The port's condensed long-history path (jepsen_tpu_torch.checker.elle
.condense, graph and parallel.check_long_history) against the JAX
package's, on the CPU, over the same encoded histories (carried across
with jepsen_tpu_torch.convert).

Tolerance: exact — edge sets, SCC partitions and their order, flag
dicts with their key order (the order anomaly names enter a verdict)."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu import parallel as r_parallel
from jepsen_tpu.checker.elle import condense as RC
from jepsen_tpu.checker.elle import encode as r_encode
from jepsen_tpu.checker.elle import graph as RG
from jepsen_tpu.checker.elle import synth as r_synth
from jepsen_tpu_torch import convert, parallel
from jepsen_tpu_torch.checker.elle import condense, graph, synth
from test_elle_append import random_history

CPU = torch.device("cpu")
ORDERS = [(False, False), (True, False), (True, True)]


@pytest.fixture(autouse=True)
def _private_aot_cache(monkeypatch, tmp_path):
    # the reference's executable cache stays out of the shared home dir
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path))


def port_enc(ref):
    return convert.encoded_from_arrays(
        **{f: getattr(ref, f) for f in convert.ENCODED_FIELDS})


def corrupted(seed: int, n_txns: int = 25):
    """A reference encoding of a random list-append history with up to
    4 corruptions and ~8% of its txns crashed (indeterminate)."""
    rng = random.Random(seed * 7 + 1)
    hist = random_history(rng, n_txns=n_txns, corrupt=rng.randint(0, 4))
    for o in hist:
        if o["type"] == "ok" and rng.random() < 0.08:
            o["type"] = "info"
            o["value"] = None
    return r_encode.encode_history(hist)


@pytest.mark.parametrize("process_order", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_edge_arrays_equal_as_sets(seed, process_order):
    ref = corrupted(seed)
    want = RC.build_edges_arrays(ref, process_order=process_order)
    got = condense.build_edges_arrays(port_enc(ref),
                                      process_order=process_order)
    assert set(zip(*(a.tolist() for a in got))) == \
        set(zip(*(a.tolist() for a in want)))
    # and equal to graph.build_edges' edge list
    host = graph.build_edges(port_enc(ref), process_order=process_order)
    assert set(zip(*(a.tolist() for a in got))) == set(host)


def groups(labels) -> set:
    g: dict = {}
    for i, s in enumerate(np.asarray(labels).tolist()):
        g.setdefault(s, set()).add(i)
    return {frozenset(v) for v in g.values()}


@pytest.mark.parametrize("realtime", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_scc_partitions_equal_reference(seed, realtime):
    ref = corrupted(seed, n_txns=30)
    enc = port_enc(ref)
    src, dst, _ = condense.build_edges_arrays(enc)
    n = enc.n
    if realtime:
        rs, rd, _ = condense.rt_aux_edges(enc)
        src, dst, n = np.concatenate([src, rs]), np.concatenate([dst, rd]), \
            2 * n
    assert groups(condense._scc_csr(n, src, dst)) == \
        groups(RC._scc_csr(n, src, dst))
    # and the members come out in the reference's order
    want, _ = RC.condense(ref, realtime=realtime)
    got, _ = condense.condense(enc, realtime=realtime)
    assert [m.tolist() for m in got] == [m.tolist() for m in want]


def test_member_order_follows_the_reference_tarjan():
    """Several nontrivial SCCs: scipy numbers them its own way, the port
    orders them as the reference's Tarjan does."""
    rng = np.random.default_rng(3)
    for _ in range(40):
        n = int(rng.integers(20, 120))
        e = int(rng.integers(n, 3 * n))
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
        labels = condense._scc_csr(n, src, dst)
        ref = RC._scc_csr(n, src, dst)
        big = np.flatnonzero(np.bincount(labels) >= 2)
        want = [int(b) for b in np.flatnonzero(np.bincount(ref) >= 2)]
        got = condense._tarjan_order(n, src, dst, labels, big) \
            if len(big) > 1 else big.tolist()
        # the same SCCs, in the same sequence
        assert [sorted(np.flatnonzero(labels == b)) for b in got] == \
            [sorted(np.flatnonzero(ref == b)) for b in want]


def test_rt_aux_reachability_equals_dense_rt():
    for seed in range(4):
        enc = port_enc(corrupted(seed + 40, n_txns=20))
        n = enc.n
        src, dst, _ = condense.build_edges_arrays(enc)
        rt = graph.order_edges(n, enc.process, enc.invoke_index,
                               RC.effective_complete_index(
                                   enc.status, enc.complete_index),
                               realtime=True)
        dense = condense._scc_csr(
            n, np.concatenate([src, [e[0] for e in rt]]).astype(np.int64),
            np.concatenate([dst, [e[1] for e in rt]]).astype(np.int64))
        asrc, adst, _ = condense.rt_aux_edges(enc)
        aux = condense._scc_csr(2 * n, np.concatenate([src, asrc]),
                                np.concatenate([dst, adst]))[:n]
        assert groups(dense) == groups(aux)


@pytest.mark.parametrize("realtime,process_order", ORDERS)
@pytest.mark.parametrize("seed", range(10))
def test_check_condensed_flags_equal_reference(seed, realtime,
                                               process_order):
    ref = corrupted(seed)
    want = RC.check_condensed(ref, realtime=realtime,
                              process_order=process_order)
    got = condense.check_condensed(port_enc(ref), CPU, realtime=realtime,
                                   process_order=process_order)
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("realtime,process_order", ORDERS)
@pytest.mark.parametrize("seed", range(4))
def test_oversized_scc_goes_to_the_host(seed, realtime, process_order):
    ref = corrupted(seed + 20, n_txns=40)
    want = RC.check_condensed(ref, realtime=realtime,
                              process_order=process_order,
                              device_scc_limit=3)
    log: list = []
    bucket_log: list = []
    got = condense.check_condensed(
        port_enc(ref), CPU, realtime=realtime, process_order=process_order,
        device_scc_limit=3, condense_log=log, bucket_log=bucket_log)
    assert list(got.items()) == list(want.items())
    rec, = log
    big = [s for s in rec["scc_sizes"] if s > 3]
    assert rec["host_scc_sizes"] == big
    assert len(bucket_log) == (1 if len(big) < len(rec["scc_sizes"])
                               else 0)


@pytest.mark.parametrize("want_witnesses", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_classify_cycles_equals_reference(seed, want_witnesses):
    """The host oracle, on scipy, against the reference's (whose
    native-kernel branch it mirrors): the same classes, witnesses and
    key order — both below and past the 64-rw-edge batching threshold."""
    ref = corrupted(seed, n_txns=25 if seed % 2 else 90)
    edges = RG.build_edges(ref, process_order=True, realtime=seed % 3 == 0)
    want = RG.classify_cycles(ref.n, edges, want_witnesses=want_witnesses)
    got = graph.classify_cycles(ref.n, edges, want_witnesses=want_witnesses)
    assert list(got.items()) == list(want.items())


def test_condense_log_records_a_cyclic_history():
    enc = port_enc(r_synth.synth_encoded_history(3_000, K=16,
                                                 inject_cycle=True))
    log: list = []
    bucket_log: list = []
    flags = condense.check_condensed(enc, CPU, condense_log=log,
                                     bucket_log=bucket_log)
    assert "G1c" in flags
    rec, = log
    assert rec["n"] == 3_000 and rec["host_scc_sizes"] == []
    assert rec["t_pads"] == [b["t_pad"] for b in bucket_log] == [128]
    assert rec["closure_rounds"] == sum(sum(b["closure_rounds"])
                                        for b in bucket_log) > 0
    assert rec["condense_seconds"] > 0 and rec["classify_seconds"] > 0


@pytest.mark.parametrize("inject", [False, True])
def test_50k_synth_history_routes_to_condensation(inject):
    enc = synth.synth_encoded_history(50_000, K=64, inject_cycle=inject)
    ref = r_synth.synth_encoded_history(50_000, K=64, inject_cycle=inject)
    for f in ("appends", "reads", "process", "invoke_index",
              "complete_index", "status"):
        assert np.array_equal(getattr(enc, f), getattr(ref, f))
    log: list = []
    flags = parallel.check_long_history(enc, CPU, realtime=not inject,
                                        process_order=not inject,
                                        condense_log=log)
    assert len(log) == 1
    if inject:
        assert "G1c" in flags and log[0]["scc_sizes"]
        assert "G1c" in RC.check_condensed(ref)
    else:
        assert flags == {} and log[0]["scc_sizes"] == []


@pytest.mark.parametrize("seed", range(3))
def test_check_long_history_routes_by_dense_limit(seed):
    ref = corrupted(seed + 4, n_txns=30)
    enc = port_enc(ref)
    dense, cond = [], []
    low = parallel.check_long_history(enc, CPU, dense_limit=enc.n,
                                      bucket_log=dense)
    high = parallel.check_long_history(enc, CPU, dense_limit=enc.n - 1,
                                       condense_log=cond)
    assert len(dense) == 1 and dense[0]["histories"] == 1   # dense route
    assert len(cond) == 1                                   # condensed
    want = r_parallel.check_long_history(ref, dense_limit=ref.n - 1)
    assert list(high.items()) == list(want.items())
    assert set(low) - {"cycle"} == set(high) - {"cycle"}


def test_long_append_store_writer(tmp_path):
    """The long-run store: valid, adjacent pair (2-txn SCC) and future
    read (one SCC of the txns between) — checked through ingest and the
    condensed path."""
    from jepsen_tpu_torch import ingest
    runs = synth.write_long_append_store(tmp_path, T=2_000, K=16,
                                         future_gap=611)
    log: list = []
    flags = [parallel.check_long_history(ingest.encode_run_dir(d), CPU,
                                         dense_limit=1_000,
                                         condense_log=log)
             for d in runs]
    assert flags[0] == {} and log[0]["scc_sizes"] == []
    assert flags[1] == {"G1c": True} and log[1]["scc_sizes"] == [2]
    assert "G1c" in flags[2] and len(log[2]["scc_sizes"]) == 1
    assert 611 // 8 < log[2]["scc_sizes"][0] <= 612
    with pytest.raises(ValueError, match="multiple of K"):
        synth.write_long_append_store(tmp_path / "x", T=2_000, K=16,
                                      future_gap=512)

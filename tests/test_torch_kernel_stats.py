"""The port's kernel search telemetry (`with_stats` / `stats_out`)
against the reference's functions on the same numpy-seeded inputs, on
the CPU: the Elle closure's round and cycle counters and the SCC shape
of its full closure (`_closure_batched_stats`, `_graph_stats`, the
pre-shortcut edge counts of `_edges_one(with_counts=True)`), the rows
`stats_row` makes of them, the dispatcher's and the edge path's
`stats_out`, `condense.condensed_stats`, the dense grid's peak
(`_scan_dense(with_stats=True)`, through `scan_dense_ref` and the
kernel's wrapper on the CPU), the bounded frontier's counters
(`_scan_history(with_stats=True)`), the WGL engines' `search_stats` and
`Linearizable.check_batch(stats_out)` over every tier.

The reference's executable cache stays private to each test
(`JEPSEN_TPU_AOT_CACHE=0`, a temporary `JEPSEN_TPU_COMPILE_CACHE_DIR`).

Tolerance: exact. Every stat is an integer count."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu.checker import linearizable as ref_linearizable
from jepsen_tpu.checker import models as ref_models
from jepsen_tpu.checker.elle import condense as rcondense
from jepsen_tpu.checker.elle import encode as rencode
from jepsen_tpu.checker.elle import kernels as RK
from jepsen_tpu.checker.elle import wr as rwr
from jepsen_tpu.checker import knossos as rkn
from jepsen_tpu.checker.knossos import dense as rdense
from jepsen_tpu.checker.knossos import encode as rkenc
from jepsen_tpu.checker.knossos import kernels as rkk
import jepsen_tpu.parallel as ref_parallel
from jepsen_tpu_torch import convert, parallel
from jepsen_tpu_torch.checker import Linearizable, models
from jepsen_tpu_torch.checker import knossos as pkn
from jepsen_tpu_torch.checker.elle import condense
from jepsen_tpu_torch.checker.elle import kernels as K
from jepsen_tpu_torch.checker.elle import synth, wr
from jepsen_tpu_torch.checker.elle.encode import encode_history
from jepsen_tpu_torch.checker.knossos import dense as pdense
from jepsen_tpu_torch.checker.knossos import encode as pkenc
from jepsen_tpu_torch.checker.knossos import kernels as pkk
from jepsen_tpu_torch.checker.knossos import synth as ksynth
from test_torch_kernels import _batch, reference_flags  # noqa: F401
from test_torch_knossos import dense_population
from test_torch_register import past_the_gate, value_rich

CPU = torch.device("cpu")
NAMES = ("appends", "reads", "invoke_index", "complete_index", "process",
         "n_txns")


@pytest.fixture(autouse=True)
def _private_aot_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path))


# -- the Elle closure's stats -------------------------------------------------

def graph_matrices(seed: int, T: int = 128):
    """[B=4,T,T] edge classes with numpy-seeded structure: history 0 a
    DAG; 1 a raw 2-cycle (cycle_round 0) on a chain; 2 three SCCs (ring
    lengths 3, 9 and 33, so cycles show at different rounds); 3 a long
    ring spread over all three classes. Rows past n_live are dead."""
    rng = np.random.default_rng(seed)
    B, n = 4, T - 7
    m = np.zeros((3, B, T, T), bool)

    def ring(cls, b, nodes):
        for i, a in enumerate(nodes):
            m[cls, b, a, nodes[(i + 1) % len(nodes)]] = True

    dag = rng.permutation(n)
    for i in range(n - 1):
        m[rng.integers(0, 3), 0, dag[i], dag[i + 1 + rng.integers(
            0, min(3, n - i - 1))]] = True
    for i in range(n - 1):
        m[0, 1, i, i + 1] = True
    m[1, 1, 20, 10] = True            # closes a 11-ring only through paths
    m[0, 1, 5, 4] = True              # a raw 2-cycle: 4 -> 5 -> 4
    nodes = rng.permutation(n)
    ring(0, 2, list(nodes[:3]))
    ring(1, 2, list(nodes[3:12]))
    ring(2, 2, list(nodes[12:45]))
    long = list(rng.permutation(n)[:80])
    for i, a in enumerate(long):
        m[i % 3, 3, a, long[(i + 1) % len(long)]] = True
    inv = np.sort(rng.integers(0, 4 * T, (B, T)), axis=1).astype(np.int64)
    comp = (inv + rng.integers(1, 3 * T, (B, T))).astype(np.int64)
    proc = rng.integers(0, 4, (B, T)).astype(np.int32)
    live = np.full(B, n, np.int32)
    return m[0], m[1], m[2], inv, comp, proc, live


@pytest.mark.parametrize("classify,fused", [(False, True), (True, True),
                                            (True, False)])
@pytest.mark.parametrize("order", [False, True])
def test_closure_and_graph_stats_match_reference(classify, fused, order):
    ww, wr_, rw, inv, comp, proc, live = graph_matrices(3)
    kw = dict(classify=classify, realtime=order, process_order=order,
              fused=fused)
    T = ww.shape[-1]
    want_flags, want = (np.asarray(x) for x in RK.classify_matrices_device(
        *(jnp.asarray(a) for a in (ww, wr_, rw, inv, comp, proc, live)),
        steps=RK.closure_steps(T), with_stats=True, **kw))
    t = [torch.from_numpy(a) for a in (ww, wr_, rw)]
    t += [torch.from_numpy(a).long() for a in (inv, comp, proc, live)]
    flags, stats = K.classify_matrices_impl(
        *t, steps=K.closure_steps(T), with_stats=True, **kw)
    assert stats.dtype == torch.int32
    assert (stats.numpy() == want).all(), (stats.numpy(), want)
    assert (flags.numpy() == want_flags).all()
    # the flags are those of the stats-off check
    assert torch.equal(flags, K.classify_matrices_impl(
        *t, steps=K.closure_steps(T), **kw))
    if order:       # realtime and process edges close cycles of their own
        return
    rows = {f: stats[:, i].tolist() for i, f in enumerate(K.STAT_FIELDS)}
    assert rows["cycle_round"][0] == -1 and rows["scc_count"][0] == 0
    assert rows["cycle_round"][1] == 0
    if not classify or fused:           # the from-scratch full closure
        assert rows["scc_count"][2] == 3
        assert rows["scc_min"][2] == 3 and rows["scc_max"][2] == 33
        assert len(set(rows["cycle_round"][1:])) == 3


@pytest.mark.parametrize("name", ["valid", "g1c", "random"])
@pytest.mark.parametrize("order", [False, True])
def test_check_batch_stats_match_reference(name, order):
    """Packed batches: the pre-shortcut edge counts, the rt/proc counts
    and the rows, with the reference's flags."""
    batch = _batch(name)
    kw = dict(classify=True, realtime=order, process_order=order,
              fused=True)
    shape = batch["shape"]
    want_flags, want = (np.asarray(x) for x in RK.check_batch_device(
        *(jnp.asarray(batch[k]) for k in NAMES), n_keys=shape.n_keys,
        max_pos=shape.max_pos, n_txns=shape.n_txns,
        steps=RK.closure_steps(shape.n_txns), with_stats=True, **kw))
    flags, stats = K.check_batch_device(
        convert.from_reference_batch(batch, CPU), with_stats=True, **kw)
    assert (flags.numpy() == want_flags).all()
    assert (stats.numpy() == want).all(), (stats.numpy(), want)
    n = batch["n_txns"]
    for r, w, k in zip(stats.tolist(), want.tolist(), n.tolist()):
        assert K.stats_row(r, n_txns=k, t_pad=shape.n_txns) == \
            RK.stats_row(np.asarray(w), n_txns=k, t_pad=shape.n_txns)


def test_edge_counts_are_counted_before_the_shortcuts():
    batch = _batch("valid")
    b = convert.from_reference_batch(batch, CPU)
    shape = batch["shape"]
    ww, wr_, rw, counts = K._edges_batched(
        b["appends"], b["reads"], shape.n_keys, shape.max_pos,
        shape.n_txns, with_counts=True)
    assert torch.equal(counts[:, 1:], torch.stack(
        [wr_.flatten(1).sum(1), rw.flatten(1).sum(1)], 1).int())
    # the shortcuts add ww edges the count leaves out
    assert (counts[:, 0] < ww.flatten(1).sum(1)).all()
    assert all(torch.equal(x, y) for x, y in zip(
        (ww, wr_, rw), K._edges_batched(b["appends"], b["reads"],
                                        shape.n_keys, shape.max_pos,
                                        shape.n_txns)))


def encs_both(n=6, T=60, every=3):
    hists = [synth.synth_append_history(T=T + 20 * (i % 3), K=6, seed=i,
                                        g1c=i % every == 1)
             for i in range(n)]
    return ([encode_history(h) for h in hists],
            [rencode.encode_history(h) for h in hists])


@pytest.mark.parametrize("fused,two_pass", [(True, False), (False, True)])
def test_dispatcher_stats_out_matches_reference(fused, two_pass):
    """check_bucketed's stats_out, over several buckets (a small cell
    budget), with and without the two-pass strategy."""
    mine, ref = encs_both()
    budget = 2 * 2 * 256 * 256
    want: list = []
    ref_res = ref_parallel.check_bucketed(ref, None, budget_cells=budget,
                                          fused=fused, two_pass=two_pass,
                                          stats_out=want)
    got: list = []
    res = parallel.check_bucketed(mine, CPU, budget_cells=budget,
                                  fused=fused, two_pass=two_pass,
                                  stats_out=got)
    assert res == ref_res and got == want
    assert all(s is not None for s in got)
    assert any(s["cycle_txns"] for s in got)


def test_injected_oom_backdown_runs_stats_free(monkeypatch):
    """A history re-checked through the OOM backdown keeps its verdict
    and has no stats (None), as in the reference."""
    from jepsen_tpu_torch import supervisor as sv
    mine, _ = encs_both(n=4)
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", "oom:first")
    sv.reset_injection()
    got: list = []
    res = parallel.check_bucketed(mine, CPU, stats_out=got)
    monkeypatch.delenv("JEPSEN_TPU_FAULT_INJECT")
    sv.reset_injection()
    clean: list = []
    assert res == parallel.check_bucketed(mine, CPU, stats_out=clean)
    assert got == [None] * 4 and None not in clean


def test_edge_batch_stats_match_reference():
    hists = [synth.wr_run_ops(T=50, K=4, seed=i, write_skew=i % 2 == 0)
             for i in range(4)]
    mine = [wr.to_edge_dict(wr.encode_wr_history(h)) for h in hists]
    ref = [rwr.to_edge_dict(rwr.encode_wr_history(h)) for h in hists]
    want: list = []
    assert RK.check_edge_batch_bucketed(ref, stats_out=want) == \
        K.check_edge_batch_bucketed(mine, CPU, stats_out=(got := []))
    assert got == want and any(s["cycle_txns"] for s in got)
    one: list = []
    K.check_edge_batch(mine, CPU, stats_out=one)
    want_one: list = []
    RK.check_edge_batch(ref, stats_out=want_one)
    assert one == want_one


@pytest.mark.parametrize("bad_every,realtime", [(2, False), (2, True),
                                                (0, True)])
def test_condensed_stats_match_reference(bad_every, realtime):
    h = synth.synth_append_history(T=160, K=6, seed=9,
                                   g1c=bad_every > 0)
    want: list = []
    rflags = rcondense.check_condensed(rencode.encode_history(h),
                                       realtime=realtime, stats_out=want)
    got: list = []
    flags = condense.check_condensed(encode_history(h), CPU,
                                     realtime=realtime, stats_out=got)
    assert flags == rflags and got == want
    assert got[0]["path"] == "condensed"
    assert (got[0]["scc_count"] > 0) == (bad_every > 0)


def test_long_history_dense_stats_match_reference():
    mine, ref = encs_both(n=2)
    for e, r in zip(mine, ref):
        want: list = []
        wflags = ref_parallel.check_long_history(r, stats_out=want)
        got: list = []
        assert parallel.check_long_history(e, CPU, stats_out=got) == wflags
        assert got == want


# -- the dense grid's peak ----------------------------------------------------

@pytest.mark.parametrize("S,V,procs,n_values", [(4, 8, 3, 5), (6, 16, 6, 12),
                                                (5, 8, 5, 5)])
def test_scan_dense_peak_matches_reference(S, V, procs, n_values):
    hs = dense_population(S, 5, n_procs=procs, n_values=n_values,
                          max_pending=S)
    ref_encs = [rdense.encode_dense_history(h) for h in hs]
    encs = [pdense.encode_dense_history(h) for h in hs]
    C = max(e.n_steps for e in encs) + 4
    want = rdense.pack_dense_batch(ref_encs, rdense.DenseBatchShape(
        n_steps=C, n_slots=S, n_values=V))
    got = pdense.pack_dense_batch(encs, pdense.DenseBatchShape(
        n_steps=C, n_slots=S, n_values=V))
    valid, peak, rounds = (np.asarray(x) for x in rdense.check_dense_device(
        want["regs"], want["comp"], n_values=V, n_slots=S,
        with_stats=True))
    regs, comp = torch.from_numpy(got["regs"]), torch.from_numpy(got["comp"])
    for scan in (pdense.scan_dense_ref, pdense.knossos_dense_scan):
        pv, pr, pp = scan(regs, comp, V, S, with_stats=True)
        assert pv.tolist() == valid.tolist()
        assert pr.tolist() == rounds.tolist()
        assert pp.tolist() == peak.tolist()
        assert pp.dtype == torch.int32
    assert (peak > 1).any()
    # the stats-off outputs are the stats-on ones less the peak
    assert all(torch.equal(a, b) for a, b in zip(
        pdense.scan_dense_ref(regs, comp, V, S),
        pdense.scan_dense_ref(regs, comp, V, S, with_stats=True)[:2]))


def test_dense_batch_stats_out_matches_reference():
    hs = (dense_population(1, 3, n_procs=2, n_values=4)
          + dense_population(2, 3, n_procs=5, n_values=4, max_pending=5))
    want: list = []
    rdense.check_encoded_dense_batch(
        [rdense.encode_dense_history(h) for h in hs], stats_out=want)
    got: list = []
    pdense.check_encoded_dense_batch(
        [pdense.encode_dense_history(h) for h in hs], "cpu",
        stats_out=got)
    assert got == want


# -- the frontier's counters, the WGL engines and the tiers -----------------

def test_scan_history_stats_match_reference():
    hs = [ksynth.synth_register_history(n_ops=24, n_procs=4, n_values=6,
                                        info_prob=0.1, seed=s)
          for s in range(3)]
    hs.append(ksynth.corrupt(hs[0], seed=1))
    want: list = []
    rres = rkk.check_encoded_batch(
        [rkenc.encode_register_history(h) for h in hs], frontier=8,
        stats_out=want)
    got: list = []
    res = pkk.check_encoded_batch(
        [pkenc.encode_register_history(h) for h in hs], frontier=8,
        device="cpu", stats_out=got)
    assert res == rres and got == want
    assert any(s["overflow"] for s in got) or \
        all(s["frontier_peak"] >= 1 for s in got)


@pytest.mark.parametrize("native", [True, False])
def test_wgl_search_stats_match_reference(native):
    hs = [ksynth.synth_register_history(n_ops=30, n_procs=4, seed=s)
          for s in range(3)]
    hs.append(ksynth.corrupt(hs[1], seed=2))
    for h in hs:
        want: dict = {}
        got: dict = {}
        if native:
            r = rkn.wgl(ref_models.cas_register(), h, search_stats=want)
            p = pkn.wgl(models.cas_register(), h, search_stats=got)
            assert got["engine"] == "wgl-native" and "backtracks" not in got
        else:
            r = rkn._wgl_python(ref_models.cas_register(), h,
                                search_stats=want)
            p = pkn._wgl_python(models.cas_register(), h,
                                search_stats=got)
            assert got["engine"] == "wgl"
        assert p == r and got == want


def test_linearizable_stats_out_over_every_tier(monkeypatch):
    """Dense, frontier and oracle keys in one batch: one dict per
    history, each from the tier that decided it, as the reference's."""
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    hs = [ksynth.synth_register_history(n_ops=30, n_procs=3, seed=4),
          value_rich(0), value_rich(1), past_the_gate(None),
          past_the_gate(99)]
    want: list = []
    rres = ref_linearizable(ref_models.cas_register(),
                            backend="tpu").check_batch({}, hs, {},
                                                       stats_out=want)
    got: list = []
    res = Linearizable(models.cas_register(), device="cpu").check_batch(
        {}, hs, {}, stats_out=got)
    assert res == rres and got == want
    assert {s["engine"] for s in got} == {"tpu-dense", "tpu-jit",
                                          "wgl-native"}

"""The port's cost-aware planner (jepsen_tpu_torch.planner) against the
reference's (jepsen_tpu.planner), on the CPU.

tests/test_planner.py's cases pointed at the port: every cold decision
is the bit-exact heuristic (`plan_buckets` is `bucket_by_length` at
multiple 128, `admission_cost` is `fold_cost`, the fused and split
defaults kept) and counts as a fallback; the fit recovers a quadratic
cost and stays finite; plan.json round-trips and a corrupt or alien one
degrades to a cold start; the routing goldens; the predicted-vs-measured
score and the report section. Each also runs in the reference on the
same inputs (a costdb and an analytics ledger made from a numpy seed)
and must give the same answer: `fit_plan`'s plan equal with floats to
1e-9 relative, and `plan_buckets`, `fused_choice`, `admission_cost`,
`split_native` and `score_against` equal exactly. Verdicts are the same
with the planner off, cold and warm, and a port sweep with
`JEPSEN_TPU_PLANNER=1` writes a plan.json with the reference's keys that
the reference loads."""

import json
import math
import os

import numpy as np
import pytest
import torch

import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu.planner as ref_planner
import jepsen_tpu.store as ref_store
import jepsen_tpu.trace as ref_trace
from jepsen_tpu.parallel import folding as ref_folding
from jepsen_tpu_torch import cli, parallel, planner, trace
from jepsen_tpu_torch import store as port_store
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.elle.encode import encode_history
from jepsen_tpu_torch.obs import device as device_obs
from jepsen_tpu_torch.parallel import folding

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for g in ("JEPSEN_TPU_PLANNER", "JEPSEN_TPU_PLANNER_PATH",
              "JEPSEN_TPU_COSTDB", "JEPSEN_TPU_KERNEL_STATS"):
        monkeypatch.delenv(g, raising=False)
    for mod in (planner, ref_planner):
        mod.deactivate()
    for tr in (trace, ref_trace):
        tr.reset()
    device_obs.reset()
    yield
    for mod in (planner, ref_planner):
        mod.deactivate()
    for tr in (trace, ref_trace):
        tr.reset()
    device_obs.reset()


def cost_records(tpads=(128, 256, 512), *, fused=True, scale=1e-3,
                 formulation="cuda-int8", provenance="measured"):
    """A synthetic quadratic costdb: device_secs grows as (T/128)²."""
    return [{
        "kernel": {"classify": True, "realtime": False,
                   "process_order": False, "fused": fused},
        "formulation": formulation,
        "geometry": {"B": 8, "n_txns": t, "n_keys": 4},
        "windows": {"dispatches": 4,
                    "device_secs": 4 * (t / 128) ** 2 * scale,
                    "histories": 32, "min_secs": scale},
        "backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
        "provenance": provenance,
    } for t in tpads]


def search_records(tpads=(128, 256, 512)):
    return [{"dir": "r", "checker": "append", "t_pad": t, "n_txns": t,
             "closure_rounds": 3, "ww_edges": t, "wr_edges": t,
             "rw_edges": t // 2, "rt_edges": 0, "proc_edges": t,
             "margin": 1, "scc_max": 1} for t in tpads]


def seeded_tables(seed: int):
    """A costdb and ledger drawn with numpy from `seed`: several modes
    (fused/two-pass, classify/detect, two formulations) over random
    geometries, noisy device seconds, a few unusable rows."""
    rng = np.random.default_rng(seed)
    cost, search = [], []
    for _ in range(int(rng.integers(6, 14))):
        t = int(rng.choice([128, 256, 384, 512, 1024, 2048, 5120]))
        hist = int(rng.integers(1, 40))
        rec = {
            "kernel": {"classify": bool(rng.random() < 0.8),
                       "realtime": bool(rng.random() < 0.2),
                       "process_order": False,
                       "fused": bool(rng.random() < 0.6)},
            "formulation": str(rng.choice(["cuda-int8",
                                           "closure_square_ref"])),
            "geometry": {"B": hist, "n_txns": t, "n_keys": 8},
            "windows": {"dispatches": int(rng.integers(1, 5)),
                        "device_secs": float(rng.uniform(0.5, 2.0)
                                             * (t / 128) ** 2 * 1e-4
                                             * hist),
                        "histories": hist,
                        "min_secs": float(rng.uniform(1e-4, 1e-3))},
            "backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
            "provenance": str(rng.choice(["measured", "estimated"])),
        }
        cost.append(rec)
    cost.append({"kernel": {"classify": True}, "geometry": {},
                 "windows": {}})
    for _ in range(int(rng.integers(5, 20))):
        t = int(rng.choice([128, 256, 512, 1024, 5120]))
        n = int(rng.integers(1, t + 1))
        search.append({"dir": "r", "checker": "append", "t_pad": t,
                       "n_txns": n,
                       "closure_rounds": int(rng.integers(0, 14)),
                       "ww_edges": int(rng.integers(0, 3 * n)),
                       "wr_edges": int(rng.integers(0, 3 * n)),
                       "rw_edges": int(rng.integers(0, 3 * n)),
                       "rt_edges": 0, "proc_edges": n})
    search.append({"dir": "k", "checker": "register"})
    return cost, search


def fitted(tpads=(128, 256, 512)):
    plan = planner.fit_plan(cost_records(tpads), search_records(tpads))
    assert plan is not None
    return plan


def install(plan, monkeypatch):
    """The same plan active in both packages."""
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    planner._active = planner.Planner(plan, "fit")
    ref_planner._active = ref_planner.Planner(plan, "fit")
    return planner._active, ref_planner._active


class E:
    def __init__(self, n):
        self.n = n


def assert_close(a, b, rel=1e-9):
    """Equal structure; floats equal to `rel`."""
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=rel, abs=1e-12)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_close(a[k], b[k], rel)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_close(x, y, rel)
    else:
        assert a == b


# -- gates and the cold start -------------------------------------------------

def test_default_off():
    assert planner.enabled() is False and planner.get() is None


def test_gate_on_yields_a_cold_planner(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    pl = planner.get()
    assert pl is not None and not pl.modeled and pl.source == "cold"


def test_planner_path_override(tmp_path, monkeypatch):
    assert port_store.plan_path(tmp_path) == tmp_path / "plan.json"
    pinned = tmp_path / "elsewhere" / "pinned.json"
    monkeypatch.setenv("JEPSEN_TPU_PLANNER_PATH", str(pinned))
    assert port_store.plan_path(tmp_path) == pinned


@pytest.mark.parametrize("n", [1, 7, 100, 128, 129, 1000, 4096, 50_000])
def test_cold_admission_cost_is_fold_cost_exactly(n, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    assert planner.get().admission_cost(n) == folding.fold_cost(n) == \
        ref_folding.fold_cost(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cold_plan_buckets_is_bucket_by_length_exactly(seed, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    rng = np.random.default_rng(seed)
    es = [E(int(n)) for n in rng.integers(1, 3000, size=25)]
    for budget in (1 << 20, 1 << 24, 1 << 27):
        got = planner.get().plan_buckets(es, budget_cells=budget)
        assert got == parallel.bucket_by_length(es, budget_cells=budget)
        assert got == ref_parallel.bucket_by_length(es, budget_cells=budget)


def test_cold_fused_and_split_keep_defaults(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    pl = planner.get()
    assert pl.fused_choice(True) is True and pl.fused_choice(False) is False
    assert pl.split_native(1) is True and pl.split_native(10 ** 9) is True


def test_every_cold_decision_counts_as_a_fallback(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    pl = planner.get()
    pl.admission_cost(100)
    pl.fused_choice(True)
    pl.split_native(5)
    pl.plan_buckets([E(10)], budget_cells=1 << 20)
    c = trace.get_current().metrics_dict()["counters"]
    assert c["planner.decisions"] == c["planner.fallbacks"] == 4
    assert c["planner.geometry"] == 1


# -- the fit ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_fit_plan_equals_the_reference_s(seed):
    cost, search = seeded_tables(seed)
    mine = planner.fit_plan(cost, search)
    ref = ref_planner.fit_plan(cost, search)
    assert mine is not None and ref is not None
    assert_close(mine, ref)
    # and each package predicts alike from it
    for t in (128, 256, 640, 5120, 1 << 20):
        for kw in ({}, {"classify": False}, {"fused": True},
                   {"fused": False}):
            a = planner.predict_secs(mine, t, **kw)
            b = ref_planner.predict_secs(mine, t, **kw)
            assert (a is None) == (b is None)
            if a is not None:
                assert a == pytest.approx(b, rel=1e-9)


def test_empty_tables_fit_none():
    assert planner.fit_plan([], []) is None
    assert planner.fit_plan(None, None) is None
    bad = [{"kernel": {"classify": True}, "geometry": {}, "windows": {}}]
    assert planner.fit_plan(bad, []) is None


def test_fit_recovers_quadratic_scaling():
    plan = fitted()
    p128, p256, p512 = (planner.predict_secs(plan, t)
                        for t in (128, 256, 512))
    assert p256 / p128 == pytest.approx(4.0, rel=0.2)
    assert p512 / p128 == pytest.approx(16.0, rel=0.2)


def test_unseen_strategy_predicts_none():
    assert planner.predict_secs(fitted(), 128, classify=False) is None


def test_prediction_is_always_finite():
    wild = planner.predict_secs(fitted(), 1 << 40)
    assert wild is not None and math.isfinite(wild) and wild <= math.exp(5)


def test_plan_carries_provenance_and_overhead():
    plan = fitted()
    assert plan["provenance"] == "measured"
    assert plan["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert plan["backend"] == "cuda"
    assert plan["trained_records"] == 3
    assert plan["overhead_secs"] == pytest.approx(1e-3)
    assert plan["split_min_ops"] == 0
    assert list(plan) == list(ref_planner.fit_plan(
        cost_records(), search_records()))


# -- plan.json ----------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [
    (planner, planner), (planner, ref_planner), (ref_planner, planner)],
    ids=["port-port", "port-ref", "ref-port"])
def test_save_load_roundtrip_across_packages(writer, reader, tmp_path):
    plan = fitted()
    p = tmp_path / "plan.json"
    assert writer.save_plan(p, plan) is True
    assert reader.load_plan(p) == json.loads(json.dumps(plan))


def test_missing_corrupt_and_alien_plans_degrade(tmp_path):
    assert planner.load_plan(tmp_path / "absent.json") is None
    p = tmp_path / "plan.json"
    for text in ("{corrupt", json.dumps([1, 2, 3]),
                 json.dumps({"v": 999, "modes": {}}),
                 json.dumps({"v": 1, "modes": "nope"})):
        p.write_text(text)
        assert planner.load_plan(p) is None


def test_refresh_persists_and_activate_warm_starts(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    plan = planner.refresh(tmp_path, cost_records(), search_records())
    assert plan is not None and (tmp_path / "plan.json").is_file()
    planner.deactivate()
    pl = planner.activate(tmp_path)
    assert pl.modeled and pl.source == "plan"
    assert planner.current_plan() == json.loads(json.dumps(plan))


def test_refresh_with_nothing_to_fit_is_a_noop(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    assert planner.refresh(tmp_path, [], []) is None
    assert not (tmp_path / "plan.json").exists()


def test_activate_gate_off_is_none(tmp_path):
    assert planner.activate(tmp_path) is None and planner.get() is None


def test_activate_a_corrupt_plan_runs_cold(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    (tmp_path / "plan.json").write_text("{torn")
    pl = planner.activate(tmp_path)
    assert pl is not None and pl.source == "cold"
    assert trace.get_current().metrics_dict()["counters"][
        "planner.cold_starts"] == 1


# -- routing, against the reference ------------------------------------------

def const_mode(secs):
    return {"coeffs": [math.log(secs), 0.0, 0.0, 0.0], "points": 3,
            "t_pad_min": 128, "t_pad_max": 512}


def two_mode_plan(fused_secs, twopass_secs):
    return {"v": 1, "device_kind": "cpu", "backend": "cpu",
            "provenance": "measured", "trained_records": 6,
            "modes": {"classify|nort|fused|cuda-int8":
                      const_mode(fused_secs),
                      "classify|nort|twopass|cuda-int8":
                      const_mode(twopass_secs)},
            "analytics": {}, "overhead_secs": 1e-3, "split_min_ops": 0}


@pytest.mark.parametrize("fused_secs,twopass_secs,want", [
    (1e-2, 1e-3, False), (1e-4, 1e-3, True), (1e-3, 1e-3, True)])
def test_fused_choice_follows_the_cheaper_strategy(
        fused_secs, twopass_secs, want, monkeypatch):
    pl, ref = install(two_mode_plan(fused_secs, twopass_secs), monkeypatch)
    for default in (True, False):
        assert pl.fused_choice(default) is want
        assert ref.fused_choice(default) is want


def test_fused_choice_needs_both_strategies_measured(monkeypatch):
    pl, ref = install(fitted(), monkeypatch)     # fused-only training
    for default in (True, False):
        assert pl.fused_choice(default) is default
        assert ref.fused_choice(default) is default


def test_admission_cost_keeps_the_cell_unit(monkeypatch):
    pl, ref = install(fitted(), monkeypatch)
    assert pl.admission_cost(100) == 128 * 128
    for n in (1, 300, 1000, 4000, 50_000):
        got = pl.admission_cost(n)
        assert got == ref.admission_cost(n) >= 1
        if 128 < n <= 4096:
            assert got == pytest.approx(folding.fold_cost(n), rel=0.1)


@pytest.mark.parametrize("seed", range(4))
def test_warm_decisions_equal_the_reference_s(seed, monkeypatch):
    cost, search = seeded_tables(seed)
    plan = planner.fit_plan(cost, search)
    plan["overhead_secs"] = float(np.random.default_rng(seed).choice(
        [1e-9, 1e-3, 10.0]))
    plan["split_min_ops"] = 50 * seed
    pl, ref = install(plan, monkeypatch)
    rng = np.random.default_rng(100 + seed)
    es = [E(int(n)) for n in rng.integers(1, 6000, size=30)]
    for budget in (1 << 22, 1 << 26):
        got = pl.plan_buckets(es, budget_cells=budget)
        assert got == ref.plan_buckets(es, budget_cells=budget)
        assert sorted(i for b in got for i in b) == list(range(len(es)))
    for n in (1, 99, 130, 5000):
        assert pl.admission_cost(n) == ref.admission_cost(n)
        assert pl.split_native(n) == ref.split_native(n)
    for default in (True, False):
        for t in (128, 1024):
            assert pl.fused_choice(default, t_pad=t) == \
                ref.fused_choice(default, t_pad=t)
    fresh = [r for r in cost if isinstance(r, dict)]
    assert pl.score_against(fresh) == ref.score_against(fresh)


def test_plan_buckets_is_a_partition_within_budget(monkeypatch):
    es = [encode_history(synth.synth_append_history(T=40 + 37 * i, K=4,
                                                    seed=i))
          for i in range(8)]
    pl, _ = install(fitted(), monkeypatch)
    budget = 1 << 22
    got = pl.plan_buckets(es, budget_cells=budget)
    assert sorted(i for b in got for i in b) == list(range(len(es)))
    assert len(got) <= len(parallel.bucket_by_length(es,
                                                     budget_cells=budget))


def test_geometry_race_prefers_fewer_dispatches_under_overhead(monkeypatch):
    es = [E(n) for n in (100, 120, 200, 220, 450, 500)]
    plan = fitted()
    plan["overhead_secs"] = 10.0
    pl, ref = install(plan, monkeypatch)
    got = pl.plan_buckets(es, budget_cells=1 << 27)
    cands = [parallel.bucket_by_length(es, multiple=m, budget_cells=1 << 27)
             for m in planner.GEOMETRY_CANDIDATES]
    assert got in cands and len(got) == min(len(c) for c in cands)
    assert got == ref.plan_buckets(es, budget_cells=1 << 27)


# -- score and report ---------------------------------------------------------

def test_score_against_fresh_records(monkeypatch):
    pl, ref = install(fitted(), monkeypatch)
    err = pl.score_against(cost_records())
    assert err == ref.score_against(cost_records())
    assert err["records"] == 3 and err["mean_rel_err"] < 0.5
    md = trace.get_current().metrics_dict()
    assert md["counters"]["planner.pred_checked"] == 3
    assert "planner.pred_err_permille" in md["gauges"]


def test_score_cold_or_alien_records_is_none(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    assert planner.get().score_against(cost_records()) is None
    pl, _ = install(fitted(), monkeypatch)
    assert pl.score_against([]) is None
    assert pl.score_against([{"windows": {}}, "junk"]) is None


def test_section_and_markdown_equal_the_reference_s(monkeypatch):
    pl, ref = install(fitted(), monkeypatch)
    for p in (pl, ref):
        p.admission_cost(100)
        p.fused_choice(True)
    sec = planner.planner_section(
        pl.plan, cost_records=cost_records(),
        metrics=trace.get_current().metrics_dict())
    ref_sec = ref_planner.planner_section(
        ref.plan, cost_records=cost_records(),
        metrics=ref_trace.get_current().metrics_dict())
    assert sec == ref_sec
    assert sec["levers"].get("admission") == 1
    assert "classify|nort|fused|cuda-int8" in sec["modes"]
    text = "\n".join(planner.render_planner_md(sec))
    assert text == "\n".join(ref_planner.render_planner_md(sec))
    assert "classify\\|nort\\|fused\\|cuda-int8" in text


def test_cold_section_renders(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    planner.get().admission_cost(64)
    sec = planner.planner_section(
        None, metrics=trace.get_current().metrics_dict())
    assert sec["modeled"] is False
    assert "cold start" in "\n".join(planner.render_planner_md(sec))


# -- the invariant: no verdict changes ----------------------------------------

def sweep_encs():
    return [encode_history(synth.synth_append_history(
        T=T, K=6, seed=i, g1c=i % 3 == 1))
        for i, T in enumerate((40, 300, 130, 90, 260, 20, 200, 470))]


def test_bucketed_sweep_parity_off_cold_warm(monkeypatch):
    es = sweep_encs()
    base = json.dumps(parallel.check_bucketed(es, CPU))
    monkeypatch.setenv("JEPSEN_TPU_PLANNER", "1")
    assert json.dumps(parallel.check_bucketed(es, CPU)) == base   # cold
    plan = fitted()
    plan["overhead_secs"] = 1e-9        # composition follows the model
    install(plan, monkeypatch)
    assert json.dumps(parallel.check_bucketed(es, CPU)) == base
    install(two_mode_plan(1e-2, 1e-3), monkeypatch)   # two-pass cheaper
    assert json.dumps(parallel.check_bucketed(es, CPU)) == base


def test_async_pipeline_parity(monkeypatch):
    es = sweep_encs()
    base = json.dumps(parallel.check_bucketed_async(es, CPU).result())
    plan = fitted()
    plan["overhead_secs"] = 10.0
    install(plan, monkeypatch)
    assert json.dumps(parallel.check_bucketed_async(es, CPU).result()) \
        == base


def test_the_planner_composes_the_async_buckets(monkeypatch):
    """With a fitted plan check_bucketed_async dispatches the buckets
    `plan_buckets` composed, not bucket_by_length's."""
    es = sweep_encs()
    plan = fitted()
    plan["overhead_secs"] = 1e-9     # per-history cost decides
    install(plan, monkeypatch)
    # the first budget (halved for two buckets in flight) at which a
    # coarser multiple composes cheaper buckets
    budget, want = next(
        (b, w) for b in (1 << k for k in range(16, 23))
        if (w := planner.get().plan_buckets(es, budget_cells=b // 2))
        != parallel.bucket_by_length(es, budget_cells=b // 2))
    log: list = []
    parallel.check_bucketed_async(es, CPU, budget_cells=budget,
                                  bucket_log=log).result()
    assert sorted(b["histories"] for b in log) == \
        sorted(len(b) for b in want)


def test_an_edge_batch_is_not_planned(monkeypatch):
    """The wr sweep's edge batches bucket as the reference's
    check_edge_batch_bucketed does, planner or not."""
    from jepsen_tpu_torch.checker.elle import kernels as K
    from jepsen_tpu_torch.checker.elle import wr

    def boom(*a, **k):
        raise AssertionError("the planner composed an edge batch")
    install(fitted(), monkeypatch)
    monkeypatch.setattr(planner.Planner, "plan_buckets", boom)
    eds = [wr.to_edge_dict(wr.encode_wr_history(
        synth.wr_run_ops(T=40, K=4, seed=i, write_skew=i == 1)))
        for i in range(3)]
    got = K.check_edge_batch_bucketed(eds, CPU)
    assert [bool(g) for g in got] == [False, True, False]


# -- whole sweeps -------------------------------------------------------------

def test_sweep_with_the_planner_writes_the_reference_s_plan(
        tmp_path, monkeypatch, capsys):
    """Cold, then warm from its own plan.json: the same verdicts as a
    sweep without the planner, plan.json with the reference's keys (the
    reference loads it), the report's planner section."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    outs = {}
    for label, env in (("off", {}), ("on", {"JEPSEN_TPU_PLANNER": "1",
                                            "JEPSEN_TPU_COSTDB": "1"})):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        store = tmp_path / label
        synth.write_synth_run_store(store, B=6, T=120, K=8, bad_every=3)
        rcs = []
        for _ in range(2):
            rcs.append(cli.main(["analyze-store", "--store", str(store),
                                 "--device", "cpu", "--report"]))
            outs[label] = (rcs, {
                str(p.relative_to(store)): p.read_bytes()
                for p in sorted(store.rglob("results.*"))},
                (store / "verdicts.jsonl").read_text().replace(
                    str(store), ""))
    err = capsys.readouterr().err
    assert outs["on"] == outs["off"]
    assert outs["on"][0] == [1, 1]
    store = tmp_path / "on"
    plan = json.loads((store / "plan.json").read_text())
    ref_plan = ref_planner.fit_plan(ref_store.load_costdb(store), [])
    assert list(plan) == list(ref_plan)
    assert ref_planner.load_plan(store / "plan.json") == plan
    assert plan["trained_records"] == len(port_store.load_costdb(store))
    assert "planner: plan.json refit from" in err
    rep = json.loads((store / "report.json").read_text())
    assert rep["planner"]["enabled"] and rep["planner"]["modeled"]
    assert "## Cost-aware planner" in (store / "report.md").read_text()
    c = json.loads((store / "metrics.json").read_text())["counters"]
    assert c["planner.geometry"] == 1 and c["planner.fused"] == 1
    ev = json.loads((store / "trace.json").read_text())["traceEvents"]
    assert {"planner.activate", "planner.fit"} <= {e["name"] for e in ev}


def test_planner_gate_off_writes_no_plan(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    synth.write_synth_run_store(tmp_path / "s", B=3, T=60, K=4, bad_every=0)
    assert cli.main(["analyze-store", "--store", str(tmp_path / "s"),
                     "--device", "cpu", "--report"]) == 0
    capsys.readouterr()
    assert not (tmp_path / "s" / "plan.json").exists()
    assert "planner" not in json.loads(
        (tmp_path / "s" / "report.json").read_text())

"""The port's plot checkers against the reference's: `checker/perf.py`
(`LatencyGraph`, `RateGraph`, `perf`), `checker/clock.py`
(`clock_plot`), the `checker` package's constructors for them, bank's
balance plot and the workloads that compose them (`bank.test()`,
`causal_reverse.workload()`).

- On the same seeded history, each package's checker gives the same
  results map and writes the same files, PNG bytes included. The two
  run in turn on one store path (bank's plot entry holds its path).
- Without matplotlib, both packages' plot entries are `"unknown"` with
  an error that names it, and the whole verdict merges to `"unknown"`.
- The pure data layer (buckets, quantiles, rates, nemesis activity)
  gives equal values.
"""

import copy
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

import jepsen_tpu.checker as ref_checker
import jepsen_tpu.checker.clock as ref_clock
import jepsen_tpu.checker.perf as ref_perf
import jepsen_tpu.store as ref_store
import jepsen_tpu.workloads.bank as ref_bank
import jepsen_tpu.workloads.causal_reverse as ref_causal_reverse
import jepsen_tpu_torch.checker as port_checker
import jepsen_tpu_torch.checker.clock as port_clock
import jepsen_tpu_torch.checker.perf as port_perf
import jepsen_tpu_torch.store as port_store
import jepsen_tpu_torch.workloads.bank as port_bank
import jepsen_tpu_torch.workloads.causal_reverse as port_causal_reverse

REF = dict(checker=ref_checker, perf=ref_perf, clock=ref_clock,
           store=ref_store, bank=ref_bank,
           causal_reverse=ref_causal_reverse)
PORT = dict(checker=port_checker, perf=port_perf, clock=port_clock,
            store=port_store, bank=port_bank,
            causal_reverse=port_causal_reverse)
NODES = ["n1.db.example", "n2.db.example", "n3.db.example"]
#: The combined fault bundle's plot shading specs (nemesis.combined).
NEMESES = [{"name": "partition", "start": {"start-partition"},
            "stop": {"stop-partition"}, "color": "#E9A4A0"},
           {"name": "clock", "start": {"bump", "strobe"},
            "stop": {"reset"}}]


def plot_history(seed: int, n: int = 240, bank: bool = False) -> list:
    """A latency-annotatable history made from a numpy seed: five client
    processes invoking and completing (ok, fail, info; one process never
    completes its last op), partitions and clock bumps from the nemesis
    with `clock-offsets` annotations. With `bank`, the clients read
    balances of four accounts and transfer between them."""
    rng = np.random.default_rng(seed)
    t, hist, pending = 0, [], {}
    balances = {0: 40, 1: 30, 2: 20, 3: 10}
    fs = ("read", "transfer") if bank else ("read", "write", "cas")
    offsets = {n: 0.0 for n in NODES}
    for i in range(n):
        t += int(rng.integers(1_000_000, 60_000_000))
        if i % 37 == 18:
            f = "start-partition" if (i // 37) % 2 == 0 else \
                "stop-partition"
            for typ in ("invoke", "info"):
                hist.append({"type": typ, "f": f, "process": "nemesis",
                             "time": t, "value": None})
                t += int(rng.integers(1_000_000, 5_000_000))
            continue
        if i % 53 == 40:
            node = NODES[int(rng.integers(0, len(NODES)))]
            offsets[node] = round(float(rng.normal(0, 0.5)), 3)
            op = {"type": "info", "f": "bump", "process": "nemesis",
                  "time": t, "value": {node: offsets[node]},
                  "clock-offsets": dict(offsets)}
            hist.append(op)
            continue
        p = int(rng.integers(0, 5))
        if p in pending:
            inv = pending.pop(p)
            typ = ["ok", "ok", "ok", "fail", "info"][int(rng.integers(0, 5))]
            val = inv["value"]
            if bank and inv["f"] == "read" and typ == "ok":
                val = dict(balances)
            elif inv["f"] == "read" and typ == "ok":
                val = int(rng.integers(0, 5))
            hist.append({"type": typ, "f": inv["f"], "process": p,
                         "time": t, "value": val})
            if bank and inv["f"] == "transfer" and typ == "ok":
                a, b, amt = val["from"], val["to"], val["amount"]
                balances[a] -= amt
                balances[b] += amt
            continue
        f = fs[int(rng.integers(0, len(fs)))]
        if f == "transfer":
            a, b = (int(x) for x in rng.choice(4, 2, replace=False))
            val = {"from": a, "to": b, "amount": int(rng.integers(1, 6))}
        elif f == "write":
            val = int(rng.integers(0, 5))
        elif f == "cas":
            val = [int(rng.integers(0, 5)), int(rng.integers(0, 5))]
        else:
            val = None
        op = {"type": "invoke", "f": f, "process": p, "time": t,
              "value": val}
        pending[p] = op
        hist.append(op)
    return hist


def run_in_turn(base: Path, make_checker, hist: list, test: dict,
                opts: dict | None = None) -> dict:
    """Each package's checker on a copy of `hist`, on one store path in
    turn; returns {pkg: (results, {file: bytes})}."""
    out = {}
    for name, P in (("ref", REF), ("port", PORT)):
        shutil.rmtree(base, ignore_errors=True)
        t = dict(test, store=P["store"].Store(base))
        res = P["checker"].check_safe(make_checker(P), t,
                                      copy.deepcopy(hist), opts or {})
        files = {str(p.relative_to(base)): p.read_bytes()
                 for p in sorted(base.rglob("*")) if p.is_file()}
        out[name] = (res, files)
    shutil.rmtree(base, ignore_errors=True)
    return out


def same(out: dict) -> dict:
    (ref_res, ref_files), (port_res, port_files) = out["ref"], out["port"]
    assert json.dumps(port_res, sort_keys=True, default=str) == \
        json.dumps(ref_res, sort_keys=True, default=str)
    assert sorted(port_files) == sorted(ref_files)
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    return port_res


# ---------------------------------------------------------------------------
# The plots, with matplotlib
# ---------------------------------------------------------------------------

PLOTS = {
    "perf_checker": (lambda P: P["checker"].perf_checker(),
                     ["latency-quantiles.png", "latency-raw.png",
                      "rate.png"]),
    "perf_with_nemeses": (lambda P: P["checker"].perf_checker(
        {"nemeses": NEMESES}),
        ["latency-quantiles.png", "latency-raw.png", "rate.png"]),
    "latency_graph": (lambda P: P["checker"].latency_graph(NEMESES),
                      ["latency-quantiles.png", "latency-raw.png"]),
    "rate_graph": (lambda P: P["checker"].rate_graph(),
                   ["rate.png"]),
    "perf_module": (lambda P: P["perf"].perf(),
                    ["latency-quantiles.png", "latency-raw.png",
                     "rate.png"]),
    "clock_plot": (lambda P: P["checker"].clock_plot(),
                   ["clock-skew.png"]),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("plot", sorted(PLOTS))
def test_plot_checker_equals_the_references(plot, seed, tmp_path):
    make, files = PLOTS[plot]
    hist = plot_history(seed)
    test = {"name": f"plots {plot}", "start-time": "run-1",
            "plot": {"nemeses": NEMESES} if seed else {}}
    out = run_in_turn(tmp_path / "store", make, hist, test)
    res = same(out)
    assert res["valid?"] is True
    got = sorted(Path(f).name for f in out["port"][1])
    assert got == sorted(files)
    assert all(b.startswith(b"\x89PNG") for b in out["port"][1].values())


def test_plots_under_a_subdirectory_equal_the_references(tmp_path):
    """`opts["subdirectory"]` (independent.checker's per-key nesting)
    places the files alike."""
    hist = plot_history(2)
    out = run_in_turn(tmp_path / "store",
                      lambda P: P["checker"].perf_checker(), hist,
                      {"name": "sub", "start-time": "run-1"},
                      {"subdirectory": ["independent", 3]})
    same(out)
    assert sorted(out["port"][1]) == [
        f"sub/run-1/independent/3/{f}" for f in
        ("latency-quantiles.png", "latency-raw.png", "rate.png")]


def test_plots_without_a_store_write_nothing():
    hist = plot_history(3)
    for make, _ in PLOTS.values():
        ref, port = (P["checker"].check_safe(make(P), {"name": "x"},
                                             copy.deepcopy(hist), {})
                     for P in (REF, PORT))
        assert port == ref and port["valid?"] is True


@pytest.mark.parametrize("seed", [0, 4])
def test_bank_checker_and_plot_equal_the_references(seed, tmp_path):
    """`bank.test()`'s checker composes the balance invariant and the
    balance plot, as the reference's does: the same results map (the
    plot's path included) and the same bank.png."""
    hist = plot_history(seed, bank=True)
    test = {"name": "bank", "start-time": "run-1", "total-amount": 100,
            "plot": {"nemeses": NEMESES}}
    out = run_in_turn(tmp_path / "store",
                      lambda P: P["bank"].test(total=100)["checker"],
                      hist, test)
    res = same(out)
    assert sorted(res) == ["bank", "plot", "valid?"]
    assert res["plot"] == {"valid?": True, "plot": str(
        tmp_path / "store" / "bank" / "run-1" / "bank.png")}
    assert list(out["port"][1]) == ["bank/run-1/bank.png"]


def test_bank_plot_without_reads_equals_the_references(tmp_path):
    hist = [o for o in plot_history(5, bank=True) if o["f"] != "read"]
    out = run_in_turn(tmp_path / "store",
                      lambda P: P["bank"].plot_checker(), hist,
                      {"name": "bank", "start-time": "run-1"})
    assert same(out) == {"valid?": True, "plot": None}
    assert out["port"][1] == {}


def checker_keys(chk) -> list:
    return sorted(chk.checker_map)


@pytest.mark.parametrize("kw", [{}, {"plot": True},
                                {"negative_balances": True}],
                         ids=["default", "plot", "negative"])
def test_bank_test_composes_the_references_checkers(kw):
    ref = ref_bank.test(**kw)["checker"]
    port = port_bank.test(**kw)["checker"]
    assert type(port).__name__ == type(ref).__name__ == "Compose"
    assert checker_keys(port) == checker_keys(ref) == ["bank", "plot"]
    assert type(port.checker_map["plot"]).__name__ == "BankPlot"
    assert port.checker_map["bank"].negative_balances == \
        ref.checker_map["bank"].negative_balances
    plain = port_bank.test(plot=False)["checker"]
    assert type(plain).__name__ == "BankChecker" == \
        type(ref_bank.test(plot=False)["checker"]).__name__


def test_sequential_workload_composes_perf_as_the_reference():
    port = port_causal_reverse.workload(NODES)["checker"]
    ref = ref_causal_reverse.workload(NODES)["checker"]
    assert checker_keys(port) == checker_keys(ref) == ["perf",
                                                       "sequential"]
    assert type(port.checker_map["perf"]).__name__ == "Compose"
    assert checker_keys(port.checker_map["perf"]) == \
        checker_keys(ref.checker_map["perf"]) == ["latency-graph",
                                                  "rate-graph"]


def test_sequential_checker_with_its_plots_equals_the_references(
        tmp_path):
    """The `sequential` workload's whole checker, its `perf` entry
    included, on a history of its own ops."""
    rng = np.random.default_rng(7)
    hist, t = [], 0
    for i in range(60):
        t += int(rng.integers(1_000_000, 20_000_000))
        p = i % 4
        if i % 3 == 2:
            op = {"f": "read", "value": [k for k in range(i // 3)]}
        else:
            op = {"f": "write", "value": i}
        hist.append({"type": "invoke", "process": p, "time": t, **op,
                     **({"value": None} if op["f"] == "read" else {})})
        hist.append({"type": "ok", "process": p, "time": t + 500_000,
                     **op})
    out = run_in_turn(
        tmp_path / "store",
        lambda P: P["causal_reverse"].workload(NODES)["checker"], hist,
        {"name": "seq", "start-time": "run-1"})
    res = same(out)
    assert sorted(res) == ["perf", "sequential", "valid?"]
    assert res["perf"]["valid?"] is True
    assert len(out["port"][1]) == 3


# ---------------------------------------------------------------------------
# Without matplotlib
# ---------------------------------------------------------------------------

def block_matplotlib(monkeypatch):
    """Every import of matplotlib (and of any submodule already loaded)
    now fails, as on a machine without it."""
    for name in [m for m in sys.modules
                 if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.mark.parametrize("plot", ["perf_checker", "latency_graph",
                                  "rate_graph", "clock_plot"])
def test_without_matplotlib_both_packages_give_unknown(plot, tmp_path,
                                                       monkeypatch):
    block_matplotlib(monkeypatch)
    make, _ = PLOTS[plot]
    hist = plot_history(0)
    out = run_in_turn(tmp_path / "store", make, hist,
                      {"name": "nompl", "start-time": "run-1"})
    for name in ("ref", "port"):
        res, files = out[name]
        assert res["valid?"] == "unknown", (name, res)
        errors = [r.get("error", "") for r in res.values()
                  if isinstance(r, dict)] or [res.get("error", "")]
        assert any("matplotlib" in e for e in errors), (name, res)
        assert not [f for f in files if f.endswith(".png")]
    def shape(res):
        """Keys and verdicts; an error's traceback names its package's
        files, so it differs."""
        return {k: (v.get("valid?") if isinstance(v, dict) else
                    v if k == "valid?" else type(v).__name__)
                for k, v in res.items()}

    assert shape(out["port"][0]) == shape(out["ref"][0])


def test_without_matplotlib_bank_is_unknown_as_the_reference(
        tmp_path, monkeypatch):
    """The balance invariant still gives its verdict; the plot entry is
    unknown, so the composed verdict is too."""
    block_matplotlib(monkeypatch)
    hist = plot_history(0, bank=True)
    out = run_in_turn(tmp_path / "store",
                      lambda P: P["bank"].test()["checker"], hist,
                      {"name": "bank", "start-time": "run-1",
                       "total-amount": 100})
    for name in ("ref", "port"):
        res, _ = out[name]
        assert res["valid?"] == "unknown"
        assert res["plot"]["valid?"] == "unknown"
        assert "matplotlib" in res["plot"]["error"]
    assert out["port"][0]["bank"] == out["ref"][0]["bank"]
    assert out["port"][0]["bank"]["valid?"] is True


# ---------------------------------------------------------------------------
# The data layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_data_layer_equals_the_references(seed):
    hist = plot_history(seed)
    rng = np.random.default_rng(seed)
    pts = [(float(t), float(v)) for t, v in
           zip(rng.uniform(0, 100, 200), rng.exponential(5, 200))]
    for fn, args in (
            ("buckets", (10, 95.0)),
            ("bucket_points", (10, pts)),
            ("quantiles", ((0.5, 0.95, 1), [p[1] for p in pts])),
            ("latencies_to_quantiles", (10, (0.5, 0.99, 1), pts)),
            ("rates", (hist, 1)),
            ("invokes_by_f", (hist,)),
            ("fs_order", ([None, "write", "read", 3],)),
            ("t_max", (hist,))):
        assert getattr(port_perf, fn)(*copy.deepcopy(args)) == \
            getattr(ref_perf, fn)(*copy.deepcopy(args)), fn
    lat_r = ref_perf.invokes_by_f_type(
        ref_perf.util.history_latencies(copy.deepcopy(hist)))
    lat_p = port_perf.invokes_by_f_type(
        port_perf.util.history_latencies(copy.deepcopy(hist)))
    assert json.dumps(lat_p, sort_keys=True, default=str) == \
        json.dumps(lat_r, sort_keys=True, default=str)
    for nem in (None, NEMESES):
        a = ref_perf.nemesis_activity(nem, copy.deepcopy(hist))
        b = port_perf.nemesis_activity(nem, copy.deepcopy(hist))
        assert json.dumps(b, sort_keys=True, default=str) == \
            json.dumps(a, sort_keys=True, default=str)
    assert port_clock.history_to_datasets(hist) == \
        ref_clock.history_to_datasets(hist)
    assert port_clock.short_node_names(NODES) == \
        ref_clock.short_node_names(NODES) == ["n1", "n2", "n3"]


def test_plot_modules_import_matplotlib_only_when_drawing():
    """The port's perf and clock modules load without matplotlib: it is
    imported in `fig_ax`, when a plot is drawn."""
    import subprocess
    code = """
import sys
sys.modules["matplotlib"] = None
from jepsen_tpu_torch import checker
from jepsen_tpu_torch.checker import clock, perf
from jepsen_tpu_torch.workloads import bank, causal_reverse
checker.perf_checker(); checker.clock_plot(); bank.test()
causal_reverse.workload(["n1"])
print("ok")
"""
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["ok"]

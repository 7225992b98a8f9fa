"""The port's chronos suite and its job-schedule checker against the
reference's.

- Every case of tests/test_chronos_checker.py on the port's copies.
- `ChronosChecker`, `solution` and `plot_solution` on seeded jobs and
  runs: each package's verdict and chronos.png, exactly.
- The client op for op against tests/fake_torch_chronos.py (the
  scheduler over HTTP, the run files over the control plane): the fake
  answers the reference's client as it answers the port's.
- The test maps, workload menus, the job generator (under a seeded
  `random` and a fixed clock) and DB setup commands as the reference's.
- End to end: the suite's own `main(["test", "--dummy", "--device",
  "cpu", ...])` against the fake, for `jobs` and for `schedule` (its
  jobs' head start moved into the past, so targets fall due inside a
  short run); both packages' `analyze --backend cpu` of the stored run,
  in turn on one path, give the same results and files.
"""

import copy
import json
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import jepsen_tpu.control as ref_control
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.suites.chronos as ref_chronos
import jepsen_tpu.suites.chronos_checker as ref_cc
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.generator as port_gen
from jepsen_tpu_torch.suites import chronos, chronos_checker as cc

from fake_torch_chronos import FakeChronos, date_ins
from test_torch_baseline_suites import (fake_hosts, map_shape,
                                        no_threads_left, plain,
                                        recheck_in_turn, run_main,
                                        same_recheck)
from test_torch_cli import reference_env  # noqa: F401
from test_torch_core_run import no_workers_left
from test_torch_plots import block_matplotlib

REF = dict(control=ref_control, gen=ref_gen, chronos=ref_chronos,
           cc=ref_cc)
PORT = dict(control=port_control, gen=port_gen, chronos=chronos, cc=cc)
PKGS = (("ref", REF), ("port", PORT))


def run(name, start, end="auto", duration=2.0):
    if end == "auto":
        end = start + duration
    return {"name": name, "node": "n1", "start": start, "end": end}


JOB = {"name": 1, "start": 100.0, "count": 3, "interval": 60.0,
       "epsilon": 10.0, "duration": 2.0}


# ---------------------------------------------------------------------------
# The reference's cases: tests/test_chronos_checker.py
# ---------------------------------------------------------------------------

def test_targets_windows_and_cutoff():
    ts = cc.job_targets(400.0, JOB)
    assert ts == [(100.0, 115.0), (160.0, 175.0), (220.0, 235.0)]
    assert ts[0][1] - ts[0][0] == JOB["epsilon"] + cc.EPSILON_FORGIVENESS


def test_targets_respect_count_and_unstarted():
    assert len(cc.job_targets(10_000.0, JOB)) == 3
    assert len(cc.job_targets(232.5, JOB)) == 3
    assert len(cc.job_targets(232.0, JOB)) == 2
    assert cc.job_targets(50.0, JOB) == []


def test_on_time_and_late_within_epsilon_valid():
    runs = [run(1, 100.0), run(1, 169.9), run(1, 234.0)]
    s = cc.job_solution(400.0, JOB, runs)
    assert s["valid?"] is True
    assert all(r is not None for _, r in s["solution"])
    assert s["extra"] == []


def test_missed_target_invalid():
    runs = [run(1, 100.0), run(1, 220.0)]
    s = cc.job_solution(400.0, JOB, runs)
    assert s["valid?"] is False
    missed = [t for t, r in s["solution"] if r is None]
    assert missed == [(160.0, 175.0)]


def test_too_late_run_does_not_satisfy():
    s = cc.job_solution(400.0, JOB,
                        [run(1, 100.0), run(1, 176.0), run(1, 220.0)])
    assert s["valid?"] is False
    assert [t for t, r in s["solution"] if r is None] == [(160.0, 175.0)]
    assert s["extra"] == [run(1, 176.0)]


def test_duplicate_runs_are_extra_not_reused():
    runs = [run(1, 100.0), run(1, 101.0), run(1, 160.0), run(1, 220.0)]
    s = cc.job_solution(400.0, JOB, runs)
    assert s["valid?"] is True
    assert s["extra"] == [run(1, 101.0)]


def test_incomplete_runs_never_satisfy():
    runs = [run(1, 100.0), run(1, 160.0, end=None), run(1, 220.0)]
    s = cc.job_solution(400.0, JOB, runs)
    assert s["valid?"] is False
    assert s["incomplete"] == [run(1, 160.0, end=None)]


def test_no_runs_all_targets_missed():
    s = cc.job_solution(400.0, JOB, None)
    assert s["valid?"] is False
    assert all(r is None for _, r in s["solution"])


def test_greedy_matches_overlapping_windows():
    job = {"name": 2, "start": 100.0, "count": 2, "interval": 8.0,
           "epsilon": 10.0, "duration": 0.0}
    s = cc.job_solution(400.0, job, [run(2, 109.0), run(2, 110.0)])
    assert s["valid?"] is True


def test_solution_groups_by_name():
    job2 = {**JOB, "name": 2, "start": 130.0}
    runs = ([run(1, 100.0), run(1, 160.0), run(1, 220.0)]
            + [run(2, 130.0), run(2, 190.0)])
    soln = cc.solution(400.0, [JOB, job2], runs)
    assert soln["valid?"] is False
    assert soln["jobs"][1]["valid?"] is True
    assert soln["jobs"][2]["valid?"] is False


def test_parse_time_formats():
    assert cc.parse_time(5) == 5.0
    assert cc.parse_time("1970-01-01T00:00:10+00:00") == 10.0
    assert cc.parse_time("1970-01-01T00:00:10Z") == 10.0
    assert cc.parse_time("1970-01-01T00:00:10,500000000+00:00") == 10.5
    assert cc.parse_time(None) is None


def test_chronos_checker_end_to_end(tmp_path):
    from jepsen_tpu_torch.store import Store
    hist = [
        {"type": "invoke", "f": "add-job", "process": 0, "time": 0,
         "value": JOB},
        {"type": "ok", "f": "add-job", "process": 0, "time": 1_000,
         "value": JOB},
        {"type": "invoke", "f": "read", "process": 1,
         "time": int(400e9)},
        {"type": "ok", "f": "read", "process": 1, "time": int(401e9),
         "value": [run(1, 100.0), run(1, 161.0), run(1, 221.0)]},
    ]
    test = {"start-time": 0.0, "name": "chronos", "start-time-str": "t",
            "store": Store(tmp_path / "store")}
    res = cc.ChronosChecker().check(test, hist, {})
    assert res["valid?"] is True
    assert res["target-count"] == 3 and res["missed-count"] == 0
    hist[-1] = {**hist[-1], "value": [run(1, 100.0), run(1, 221.0)]}
    res = cc.ChronosChecker().check(test, hist, {})
    assert res["valid?"] is False
    assert res["missed-count"] == 1
    bad_hist = [h for h in hist if h.get("f") != "read"]
    assert cc.ChronosChecker().check(test, bad_hist, {})["valid?"] \
        == "unknown"


def test_plot_writes_png(tmp_path):
    soln = cc.solution(400.0, [JOB],
                       [run(1, 100.0), run(1, 160.0, end=None)])
    p = tmp_path / "chronos.png"
    cc.plot_solution(soln, 0.0, p)
    assert p.stat().st_size > 0


def test_job_schedule_and_command_strings():
    assert chronos.job_schedule_str(JOB) == \
        "R3/1970-01-01T00:01:40.000Z/PT60.0S"
    cmd = chronos.job_command(JOB)
    assert "mktemp -p /tmp/chronos-test" in cmd
    assert "sleep 2.0" in cmd and 'echo "1"' in cmd


def test_parse_run_file_shapes():
    full = chronos.parse_run_file(
        "n2", "7\n2026-01-01T00:00:10,5+00:00\n2026-01-01T00:00:12Z\n")
    assert full["name"] == 7 and full["node"] == "n2"
    assert cc.parse_time(full["end"]) > cc.parse_time(full["start"])
    partial = chronos.parse_run_file("n1", "7\n2026-01-01T00:00:10Z")
    assert partial["end"] is None
    assert chronos.parse_run_file("n1", "7")["start"] is None


def test_add_job_generator_jobs_never_self_overlap():
    g = chronos.add_job_generator()
    ctx = port_gen.Context.for_test({"concurrency": 2})
    seen = 0
    for _ in range(20):
        res = port_gen.op(g, {"concurrency": 2}, ctx)
        if res is None:
            break
        op_, g = res
        if op_ is port_gen.PENDING:
            break
        j = op_["value"]
        assert j["interval"] > (j["duration"] + j["epsilon"]
                                + cc.EPSILON_FORGIVENESS)
        ctx = ctx.with_time(op_["time"])
        seen += 1
    assert seen > 0


def test_chronos_test_default_workload_is_schedule():
    t = chronos.chronos_test({"ssh": {"dummy": True}})
    assert t["workload"] == "schedule"
    assert isinstance(t["checker"], cc.ChronosChecker)
    legacy = chronos.chronos_test({"ssh": {"dummy": True},
                                   "workload": "jobs"})
    assert legacy["workload"] == "jobs"


def test_parse_run_file_garbage_name_is_unmatchable_not_fatal():
    r = chronos.parse_run_file("n1", "garbage\n2026-01-01T00:00:10Z")
    assert r["name"] is None and r["start"] == "2026-01-01T00:00:10Z"


def test_truncated_timestamps_parse_to_none_not_crash():
    r = chronos.parse_run_file("n1", "12\n2026-01-01T00:0")
    assert r["name"] == 12 and r["start"] is None
    r2 = chronos.parse_run_file(
        "n1", "12\n2026-01-01T00:00:10,5+00:00\n2026-01-")
    assert r2["start"] is not None and r2["end"] is None
    s = cc.job_solution(400.0, JOB, [dict(r, name=1)])
    assert s["valid?"] is False


def test_solution_surfaces_unparseable_runs():
    runs = [run(1, 100.0), run(1, 160.0), run(1, 220.0),
            {"name": None, "node": "n1", "start": 100.0, "end": 102.0},
            {"name": 1, "node": "n2", "start": None, "end": 163.0}]
    soln = cc.solution(400.0, [JOB], runs)
    assert soln["valid?"] is True
    assert len(soln["unparseable"]) == 2
    assert {r["node"] for r in soln["unparseable"]} == {"n1", "n2"}


# ---------------------------------------------------------------------------
# The checker on seeded jobs and runs
# ---------------------------------------------------------------------------

def seeded_jobs_and_runs(seed: int) -> tuple:
    """Seeded jobs (the generator's shape) and their runs: most on time,
    some late, early, duplicated, incomplete, missing, unparseable, or
    written as `date -Ins` strings."""
    rng = np.random.default_rng(seed)
    # even seeds: every target met (duplicates aside)
    low = 0 if seed % 2 else 4
    jobs, runs = [], []
    for name in range(1, int(rng.integers(1, 6)) + 1):
        dur = int(rng.integers(0, 10))
        eps = 10 + int(rng.integers(0, 20))
        job = {"name": name, "start": 1000.0 + float(rng.integers(0, 60)),
               "count": 1 + int(rng.integers(0, 12)), "duration": dur,
               "epsilon": eps,
               "interval": 1 + dur + eps + 5 + int(rng.integers(0, 30))}
        jobs.append(job)
        for k in range(job["count"]):
            t = job["start"] + k * job["interval"]
            kind = int(rng.integers(low, 10))
            if kind == 0:
                continue                                    # missed
            late = float(rng.uniform(0, eps + 8)) if kind == 1 \
                else float(rng.uniform(0, 2))
            start = t + late if kind != 2 else t - 1.0     # early
            end = None if kind == 3 else start + dur
            as_str = bool(rng.integers(0, 2))
            r = {"node": f"n{1 + k % 5}", "name": name,
                 "start": date_ins(start) if as_str else start,
                 "end": (date_ins(end) if as_str else end)
                 if end is not None else None}
            runs.append(r)
            if kind == 4:
                runs.append(dict(r, node="n9"))              # duplicate
    if rng.integers(0, 3) == 0:
        runs.append({"node": "n1", "name": None, "start": 1001.0,
                     "end": 1002.0})
    return jobs, runs, 1000.0 + float(rng.integers(100, 600))


def canon(x) -> str:
    return json.dumps(plain(x), sort_keys=True, default=str)


@pytest.mark.parametrize("seed", range(12))
def test_solution_equals_the_references(seed):
    jobs, runs, read_time = seeded_jobs_and_runs(seed)
    ref = ref_cc.solution(read_time, copy.deepcopy(jobs),
                          copy.deepcopy(runs))
    port = cc.solution(read_time, copy.deepcopy(jobs), copy.deepcopy(runs))
    assert canon(port) == canon(ref)


def chronos_history(jobs: list, runs: list, read_time: float) -> list:
    hist = []
    for i, j in enumerate(jobs):
        hist += [{"type": "invoke", "f": "add-job", "process": i % 3,
                  "time": i * 1_000, "value": j},
                 {"type": "ok", "f": "add-job", "process": i % 3,
                  "time": i * 1_000 + 500, "value": j}]
    hist += [{"type": "invoke", "f": "read", "process": 4,
              "time": int((read_time - 1000.0) * 1e9)},
             {"type": "ok", "f": "read", "process": 4,
              "time": int((read_time - 999.0) * 1e9), "value": runs}]
    return hist


@pytest.mark.parametrize("seed", range(6))
def test_chronos_checker_and_plot_equal_the_references(seed, tmp_path):
    """Each package's ChronosChecker on the same seeded history in turn
    on one store path: the same results and chronos.png bytes."""
    from jepsen_tpu.store import Store as RefStore
    from jepsen_tpu_torch.store import Store as PortStore
    jobs, runs, read_time = seeded_jobs_and_runs(seed)
    hist = chronos_history(jobs, runs, read_time)
    got = {}
    for name, P, store in (("ref", REF, RefStore), ("port", PORT,
                                                    PortStore)):
        test = {"start-time": 1000.0, "name": "chronos",
                "store": store(tmp_path / "store")}
        res = P["cc"].ChronosChecker().check(test, copy.deepcopy(hist), {})
        pngs = sorted((tmp_path / "store").rglob("chronos.png"))
        got[name] = (canon(res), [p.read_bytes() for p in pngs])
        for p in pngs:
            p.unlink()
    assert got["port"] == got["ref"]
    assert got["port"][1] and got["port"][1][0][:4] == b"\x89PNG"


def test_seeded_histories_reach_every_verdict():
    valid = set()
    for seed in range(6):
        jobs, runs, read_time = seeded_jobs_and_runs(seed)
        valid.add(cc.solution(read_time, jobs, runs)["valid?"])
    assert valid == {True, False}


def test_checker_without_matplotlib_as_the_reference(tmp_path,
                                                     monkeypatch):
    """Without matplotlib the plot fails inside the checker and the
    verdict stands, in both packages: no chronos.png."""
    from jepsen_tpu.store import Store as RefStore
    from jepsen_tpu_torch.store import Store as PortStore
    block_matplotlib(monkeypatch)
    jobs, runs, read_time = seeded_jobs_and_runs(0)
    hist = chronos_history(jobs, runs, read_time)
    got = {}
    for name, P, store in (("ref", REF, RefStore), ("port", PORT,
                                                    PortStore)):
        test = {"start-time": 1000.0, "name": "chronos",
                "store": store(tmp_path / name)}
        got[name] = canon(P["cc"].ChronosChecker().check(test, hist, {}))
    assert got["port"] == got["ref"]
    assert not list(tmp_path.rglob("*.png"))


# ---------------------------------------------------------------------------
# The suite's strings, client and fake
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_suite_strings_equal_the_references(seed):
    jobs, runs, _ = seeded_jobs_and_runs(seed)
    for j in jobs:
        for P in (REF, PORT):
            assert P["chronos"].job_schedule_str(j) == \
                ref_chronos.job_schedule_str(j)
            assert P["chronos"].job_command(j) == ref_chronos.job_command(j)
    for r in runs:
        if r["name"] is None or not isinstance(r["start"], str):
            continue
        text = "\n".join([str(r["name"]), r["start"]]
                         + ([r["end"]] if r["end"] else []))
        for cut in (len(text), len(text) - 7, 3):
            assert chronos.parse_run_file("n3", text[:cut]) == \
                ref_chronos.parse_run_file("n3", text[:cut])


def client_session(P, fake: FakeChronos, now: float) -> list:
    """Jobs added (one due in the past, one not yet), a run-once job of
    the legacy workload, the run read, the marker read, an unknown f,
    and a scheduler nobody listens on."""
    nodes = ["n1", "n2", "n3"]
    test = {"nodes": nodes, "remote": fake,
            "db-hosts": {n: ("127.0.0.1", fake.port) for n in nodes}}
    c = P["chronos"].ChronosClient().open(test, "n2")
    jobs = [{"name": 1, "start": now - 100.0, "count": 4, "duration": 3,
             "epsilon": 10, "interval": 30},
            {"name": 2, "start": now + 1000.0, "count": 2, "duration": 1,
             "epsilon": 12, "interval": 40}]
    ops = [("add-job", j) for j in jobs] + [
        ("add", 7), ("add", 8), ("read", None), ("frob", None)]
    out = [c.invoke(test, {"type": "invoke", "f": f, "value": v,
                           "process": 0}) for f, v in ops]
    out.append(c.invoke({**test, "workload": "jobs"},
                        {"type": "invoke", "f": "read", "process": 0}))
    refused = {"nodes": nodes, "remote": fake,
               "db-hosts": {n: ("127.0.0.1", 1) for n in nodes}}
    c = P["chronos"].ChronosClient(timeout=2.0).open(refused, "n1")
    out += [c.invoke(refused, {"type": "invoke", "f": "add-job",
                               "value": jobs[0], "process": 0})]
    for o in out[-1:]:
        o["error"] = "refused" if "refused" in o["error"] else o["error"]
    # run times are the fake's own clock: compare what they say
    for o in out:
        if o["f"] == "read" and o["type"] == "ok" \
                and isinstance(o["value"], list) and o["value"] \
                and isinstance(o["value"][0], dict):
            o["value"] = [(r["node"], r["name"], r["end"] is not None)
                          for r in o["value"]]
    return [plain(o) for o in out]


def test_fake_answers_both_clients_alike():
    got = {}
    now = time.time()
    for name, P in PKGS:
        with FakeChronos(nodes=("n1", "n2", "n3")) as fake:
            got[name] = client_session(P, fake, now)
            got[name].append(len(fake.jobs))
    assert got["port"] == got["ref"]
    out = got["port"]
    assert [o["type"] for o in out[:-1]] == [
        "ok", "ok", "ok", "ok", "ok", "fail", "ok", "info"]
    # job 1's four targets are past: a complete run each, on the nodes
    # in turn; job 2's are all ahead
    assert out[4]["value"] == [["n1", 1, True], ["n1", 1, True],
                               ["n2", 1, True], ["n3", 1, True]]
    assert out[6]["value"] == [7, 8]
    assert out[-1] == 2


def test_fake_runs_follow_the_targets():
    """A job's run k starts LAG s after its target and ends its duration
    later; a run not yet ended has no end line; a run not yet begun is
    not there."""
    from fake_torch_chronos import LAG
    with FakeChronos(nodes=("n1",)) as fake:
        fake.add({"name": "3", "schedule":
                  "R3/2026-01-01T00:00:00.000Z/PT60S",
                  "command": chronos.job_command(
                      {"name": 3, "duration": 5})})
        t0 = cc.parse_time("2026-01-01T00:00:00Z")
        got = [chronos.parse_run_file("n1", r)
               for r in fake.runs("n1", now=t0 + 60 + LAG + 2)]
    assert [(cc.parse_time(r["start"]) - t0, r["end"] is None)
            for r in got] == [(LAG, False), (60 + LAG, True)]
    assert cc.parse_time(got[0]["end"]) - cc.parse_time(
        got[0]["start"]) == 5


# ---------------------------------------------------------------------------
# Test maps, menus, generators and DB commands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    {}, {"workload": "jobs"}, {"workload": "schedule", "time-limit": 1},
    {"faults": ["partition"]}])
def test_test_maps_and_menus_equal_the_references(opts):
    assert sorted(chronos.workloads({})) == sorted(
        ref_chronos.workloads({}))
    ref = ref_chronos.chronos_test(copy.deepcopy(opts))
    port = chronos.chronos_test(copy.deepcopy(opts))
    assert map_shape(port) == map_shape(ref)


def test_job_generators_draw_as_the_references(monkeypatch):
    """add_job_generator's jobs and the legacy add generator under a
    seeded `random` and a fixed clock: op for op the reference's."""
    monkeypatch.setattr(time, "time", lambda: 1_792_000_000.0)
    got = {}
    for name, P in PKGS:
        random.seed(5)
        ops = []
        for make in (P["chronos"].add_job_generator,
                     P["chronos"].generator):
            g = make()
            ctx = P["gen"].Context.for_test({"concurrency": 2})
            for _ in range(15):
                op_, g = P["gen"].op(g, {"concurrency": 2}, ctx)
                ops.append(plain(op_))
                ctx = ctx.with_time(op_["time"])
        got[name] = ops
    assert got["port"] == got["ref"]
    assert got["port"][0]["value"]["start"] == 1_792_000_010.0


def test_db_setup_commands_as_the_references(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    out = {}
    for name, P in PKGS:
        import importlib
        importlib.import_module(
            f"{P['control'].__name__}.net").clear_ip_cache()
        test = P["chronos"].chronos_test({"ssh": {"dummy": True},
                                          "nodes": ["n1", "n2", "n3"]})

        def lifecycle(t, n):
            t["os"].setup(t, n)
            t["db"].setup(t, n)
            t["db"].teardown(t, n)

        P["control"].on_nodes(test, lifecycle)
        out[name] = sorted((n, k, str(p))
                           for n, k, p in test["remote"].actions)
    assert out["port"] == out["ref"]
    assert any("chronos" in p for _n, k, p in out["port"]
               if k == "execute")


# ---------------------------------------------------------------------------
# End to end through the suite's main
# ---------------------------------------------------------------------------

def main_run(workload: str, tmp_path: Path, monkeypatch,
             device=("--device", "cpu")):
    """chronos's main against the fake, 2.5 s, the partitioner every
    0.3 s; for `schedule`, every job's head start is a minute in the
    past. Returns (exit code, JSON lines, the fake)."""
    if workload == "schedule":
        real = chronos.add_job_generator
        monkeypatch.setattr(chronos, "add_job_generator",
                            lambda head_start=10.0: real(-60.0))
    argv = ["test", "--dummy", *device, "--store", str(tmp_path / "port"),
            "--concurrency", "5", "--workload", workload]
    with FakeChronos() as fake:
        rc, lines = run_main(
            monkeypatch, chronos, "chronos_test",
            {"db-hosts": fake_hosts(fake), "time-limit": 2.5,
             "nemesis-interval": 0.3}, argv, fake)
    return rc, lines, fake


@pytest.mark.parametrize("workload,mpl", [("jobs", True),
                                          ("schedule", True),
                                          ("schedule", False)])
def test_suite_main_equals_the_reference(workload, mpl, tmp_path,
                                         reference_env, monkeypatch):
    """chronos's `main` (`test --dummy --device cpu --workload W`)
    against the fake: valid, every target met; the two packages'
    re-checks of the stored run, in turn on one path, give the same
    results and files (chronos.png where matplotlib is installed)."""
    if not mpl:
        block_matplotlib(monkeypatch)
    before = set(threading.enumerate())
    rc, lines, fake = main_run(workload, tmp_path, monkeypatch)
    assert no_workers_left() and no_threads_left(before)
    assert rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True
    run_dir = Path(lines[0]["dir"])
    res = json.loads((run_dir / "results.json").read_text())
    hist = [json.loads(ln) for ln in
            (run_dir / "history.jsonl").read_text().splitlines()]
    assert {o["f"] for o in hist if o["process"] == "nemesis"} <= {
        "start", "stop"}
    assert any("iptables" in str(p) for _n, k, p in fake.actions
               if k == "execute")
    if workload == "schedule":
        assert res["target-count"] >= 1 and res["missed-count"] == 0
        assert (run_dir / "chronos.png").is_file() == mpl
    else:
        assert res["ok-count"] >= 1 and res["lost-count"] == 0
    out = recheck_in_turn(
        run_dir, tmp_path,
        lambda P: P["chronos"].workloads({})[workload]()["checker"],
        monkeypatch, pkgs=(REF, PORT))
    got = same_recheck(out)
    assert got == res
    assert sorted(out["port"][2]) == (["chronos.png", "results.edn",
                                       "results.json"]
                                      if workload == "schedule" and mpl
                                      else ["results.edn",
                                            "results.json"])

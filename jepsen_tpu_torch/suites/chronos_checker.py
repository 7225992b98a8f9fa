"""Chronos job-schedule checker.

Counterpart of chronos/src/jepsen/chronos/checker.clj (321 LoC): given
the jobs a test scheduled (each with a start, repeat count, interval,
epsilon tolerance and run duration) and the runs a final read collected
off the nodes, verify that every *target* invocation window — the k-th
scheduled occurrence, widened by the job's epsilon plus a small global
forgiveness — was satisfied by a distinct completed run.

Where the reference poses the target→run assignment as a finite-domain
constraint program (checker.clj:116-189, loco `$distinct`/`$nth`), this
solves the same problem directly: targets of one job are uniform-width
windows sorted by start time, so the bipartite "each window needs its
own run-start point" matching is solved exactly by a single
earliest-window-first / earliest-feasible-run greedy pass (the classic
exchange argument for interval point-matching — any satisfiable
instance is satisfied by the greedy choice, in O(targets + runs)
instead of a CP solve).

Times are plain epoch seconds (floats); ISO-8601 strings (including
the comma-fraction variant `date -Ins` emits, checker.clj's
parse-file-time counterpart lives in the suite) are normalized on the
way in.

The port's copy of `jepsen_tpu/suites/chronos_checker.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from datetime import datetime

from .. import checker as jchecker
from ..util import iso_to_epoch

# The reference lets chronos miss deadlines by a few extra seconds
# (checker.clj:26-28).
EPSILON_FORGIVENESS = 5.0


def parse_time(t) -> float | None:
    """Normalize a timestamp to epoch seconds. Accepts numbers,
    datetimes, and ISO-8601 strings — `date -u -Ins` separates
    fractional seconds with a comma, which is valid ISO but worth
    normalizing before parsing (chronos.clj:143-149). NAIVE datetimes
    are interpreted as LOCAL time: the one naive producer is core.py's
    `start-time` (datetime.now().strftime), and shifting it to UTC
    would skew read_time by the host's UTC offset against the jobs'
    true-epoch start values."""
    if t is None:
        return None
    if isinstance(t, (int, float)):
        return float(t)
    if isinstance(t, datetime):
        return t.timestamp()       # naive -> local, aware -> exact
    return iso_to_epoch(str(t))    # full-precision (date -Ins is ns)


def job_targets(read_time: float, job: dict) -> list[tuple[float, float]]:
    """[start, stop] windows for every target that MUST have begun by
    the time of the read (checker.clj:30-47): a job may start up to
    epsilon late and takes duration to finish, so only targets before
    `read_time - epsilon - duration` are required; each window extends
    epsilon + forgiveness past its target time."""
    start = parse_time(job["start"])
    interval = float(job["interval"])
    epsilon = float(job["epsilon"])
    duration = float(job["duration"])
    finish = read_time - epsilon - duration
    out = []
    for k in range(int(job["count"])):
        t = start + k * interval
        if not t < finish:
            break
        out.append((t, t + epsilon + EPSILON_FORGIVENESS))
    return out


def split_complete(runs: list[dict]) -> tuple[list[dict], list[dict]]:
    """Partition runs into (completed, incomplete), each sorted by
    start (checker.clj:59-76). A run without an :end began but never
    finished — it can't satisfy a target."""
    runs = [r for r in runs if r.get("start") is not None]
    complete = sorted((r for r in runs if r.get("end") is not None),
                      key=lambda r: parse_time(r["start"]))
    incomplete = sorted((r for r in runs if r.get("end") is None),
                        key=lambda r: parse_time(r["start"]))
    return complete, incomplete


def match_targets(targets: list[tuple[float, float]],
                  runs: list[dict]) -> list[dict | None]:
    """Assign each target window a DISTINCT completed run whose start
    falls inside it, maximizing the number of satisfied targets.

    Both lists are sorted by start and all windows share one width, so
    greedy earliest-window-first taking the earliest feasible run is
    optimal: any run skipped here (started before the current window)
    can never satisfy a later window either. Equivalent to the
    reference's `$distinct` + `$nth` constraint solve
    (checker.clj:146-168) on satisfiable instances, and to its
    disjoint-job-solution riffle (checker.clj:78-114) on overlap-free
    failures."""
    out: list[dict | None] = []
    i = 0
    for (t0, t1) in targets:
        while i < len(runs) and parse_time(runs[i]["start"]) < t0:
            i += 1          # too early for this and every later window
        if i < len(runs) and parse_time(runs[i]["start"]) <= t1:
            out.append(runs[i])
            i += 1
        else:
            out.append(None)
    return out


def job_solution(read_time: float, job: dict,
                 runs: list[dict] | None) -> dict:
    """Solve one job (checker.clj:116-189). Returns
    {valid?, job, solution: [(target, run-or-None)...],
     extra: completed-but-unneeded runs, complete, incomplete}."""
    targets = job_targets(read_time, job)
    complete, incomplete = split_complete(runs or [])
    assigned = match_targets(targets, complete)
    used = {id(r) for r in assigned if r is not None}
    return {
        "valid?": all(r is not None for r in assigned),
        "job": job,
        "solution": list(zip(targets, assigned)),
        "extra": [r for r in complete if id(r) not in used],
        "complete": complete,
        "incomplete": incomplete,
    }


def solution(read_time: float, jobs: list[dict],
             runs: list[dict]) -> dict:
    """All jobs (checker.clj:191-213): group runs by job name, solve
    each, valid? iff every job is."""
    # Runs whose file couldn't be parsed to a job name OR a start
    # timestamp (partial writes, stray files): can't match/classify —
    # surface them rather than silently dropping corruption evidence.
    by_name: dict = {}
    unparseable = []
    for r in runs:
        if r.get("name") is None or r.get("start") is None:
            unparseable.append(r)
        else:
            by_name.setdefault(r["name"], []).append(r)
    solns = {j["name"]: job_solution(read_time, j,
                                     by_name.get(j["name"]))
             for j in jobs}
    return {
        "valid?": all(s["valid?"] for s in solns.values()),
        "jobs": solns,
        "extra": [r for s in solns.values() for r in s["extra"]],
        "incomplete": [r for s in solns.values()
                       for r in s["incomplete"]],
        "unparseable": unparseable,
        "read-time": read_time,
    }


def plot_solution(soln: dict, start_time: float, path) -> None:
    """chronos.png (checker.clj:223-292): one row per job; target
    windows shaded green when satisfied / red when missed, run spans
    drawn as solid bars (green complete, red incomplete)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    green, red = "#00AB01", "#AB0001"
    fig, ax = plt.subplots(figsize=(9, 4))
    rows = sorted(soln["jobs"])
    for y, name in enumerate(rows, start=1):
        s = soln["jobs"][name]
        for (t0, t1), run in s["solution"]:
            ax.add_patch(Rectangle(
                (t0 - start_time, y + 0.1), t1 - t0, 0.8,
                facecolor=green if run is not None else red, alpha=0.3,
                edgecolor="none"))
        for run in s["complete"] + s["incomplete"]:
            r0 = parse_time(run["start"]) - start_time
            r1 = max(r0 + 1, (parse_time(run["end"]) - start_time)
                     if run.get("end") is not None else r0 + 1)
            ax.add_patch(Rectangle(
                (r0, y + 0.4), r1 - r0, 0.2,
                facecolor=green if run.get("end") is not None else red,
                edgecolor="none"))
    ax.set_xlim(0, max(1.0, soln["read-time"] - start_time))
    ax.set_ylim(0, len(rows) + 1)
    ax.set_ylabel("Job")
    ax.set_xlabel("Time (s)")
    fig.savefig(path, dpi=96)
    plt.close(fig)


class ChronosChecker(jchecker.Checker):
    """The suite checker (checker.clj:294-321): read-time comes from
    the final read's INVOKE (runs observed by the read can't postdate
    its issue), runs from the read's :ok value, jobs from every
    successful add-job."""

    def check(self, test, history, opts):
        read_inv = next((o for o in reversed(history)
                         if o.get("type") == "invoke"
                         and o.get("f") == "read"), None)
        read_ok = next((o for o in reversed(history)
                        if o.get("type") == "ok"
                        and o.get("f") == "read"), None)
        if read_ok is None or read_inv is None:
            return {"valid?": "unknown", "error": "no final read"}
        start_time = parse_time(test.get("start-time")) or 0.0
        read_time = start_time + read_inv.get("time", 0) / 1e9
        jobs = [o["value"] for o in history
                if o.get("type") == "ok" and o.get("f") == "add-job"]
        soln = solution(read_time, jobs, read_ok["value"] or [])
        try:
            from ..checker.perf import store_path
            p = store_path(test, opts, "chronos.png")
            if p is not None:
                plot_solution(soln, start_time, p)
        except Exception:
            pass                       # the verdict never dies on a plot
        # summary counts ride along for the one-line report
        missed = sum(1 for s in soln["jobs"].values()
                     for (_, r) in s["solution"] if r is None)
        soln["target-count"] = sum(len(s["solution"])
                                   for s in soln["jobs"].values())
        soln["missed-count"] = missed
        soln["extra-count"] = len(soln["extra"])
        return soln

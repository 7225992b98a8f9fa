"""Chronos suite.

Counterpart of chronos/src/jepsen/chronos/ (750 LoC): Chronos job
scheduling over Mesos + ZooKeeper — jobs are scheduled via Chronos's
HTTP API and the checker verifies every job ran on time by reading
run-marker files off the nodes. The HTTP scheduling client is real
(urllib); the mesos/zk stack installs are the DB layer.

The port's copy of `jepsen_tpu/suites/chronos.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import json
import re as _re
import urllib.error
import urllib.request

from .. import checker as jchecker
from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis, os_setup
from . import base_opts, nemesis_cycle
from . import chronos_checker
from .sql import resolve


class ChronosDB(jdb.DB, jdb.LogFiles):
    """zookeeper + mesos master/agent + chronos via apt
    (chronos/src/jepsen/chronos.clj's setup)."""

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("apt-get", "install", "-y",
                  "zookeeperd", "mesos", "chronos")
        # fresh run-log dir: stale files from a previous test on the
        # same node would read as this test's runs (job names restart
        # at 1), masking real misses; legacy markers likewise
        sess.exec("rm", "-rf", JOB_DIR)
        sess.exec("sh", "-c", "rm -f /tmp/chronos-run-*")
        sess.exec("mkdir", "-p", JOB_DIR)
        nodes = test.get("nodes", [node])
        zk = ",".join(f"{n}:2181" for n in nodes)
        sess.exec("sh", "-c",
                  f"echo zk://{zk}/mesos > /etc/mesos/zk")
        sess.exec("service", "zookeeper", "restart")
        sess.exec("service", "mesos-master", "restart")
        sess.exec("service", "mesos-slave", "restart")
        sess.exec("service", "chronos", "restart")

    def teardown(self, test, node):
        sess = control.current_session().su()
        for svc in ("chronos", "mesos-slave", "mesos-master",
                    "zookeeper"):
            sess.exec_ok("service", svc, "stop")

    def log_files(self, test, node):
        return ["/var/log/chronos/chronos.log",
                "/var/log/mesos/mesos-master.INFO"]


JOB_DIR = "/tmp/chronos-test"


def job_schedule_str(job: dict) -> str:
    """ISO8601 repeating interval (chronos.clj:101-106):
    R<count>/<start>/PT<interval>S."""
    from datetime import datetime, timezone
    start = chronos_checker.parse_time(job["start"])
    iso = datetime.fromtimestamp(start, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"
    return f"R{job['count']}/{iso}/PT{job['interval']}S"


def job_command(job: dict) -> str:
    """Each run logs its job name, start and end times into a fresh
    tempfile the final read collects (chronos.clj:108-116)."""
    return (f"MEW=$(mktemp -p {JOB_DIR}); "
            f"echo \"{job['name']}\" >> $MEW; "
            "date -u -Ins >> $MEW; "
            f"sleep {job['duration']}; "
            "date -u -Ins >> $MEW;")


def parse_run_file(node: str, text: str) -> dict:
    """name / start / end lines -> a run map (chronos.clj:152-159);
    a file with no end line is an incomplete run."""
    lines = text.strip().split("\n")
    try:
        name = int(lines[0]) if lines and lines[0].strip() else None
    except ValueError:
        # Partial write / stray file: a run with name None can't match
        # any job, so the checker surfaces it under "unparseable"
        # instead of the until-ok final read raise-retrying forever.
        name = None
    return {"node": node,
            "name": name,
            "start": _ts(lines[1]) if len(lines) > 1 else None,
            "end": _ts(lines[2]) if len(lines) > 2 else None}


_TS_RE = _re.compile(r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}")


def _ts(line: str) -> str | None:
    """A truncated `date -u -Ins` line (partial write) is no timestamp:
    return None so the run counts as incomplete, not a checker crash."""
    s = line.strip()
    return s if _TS_RE.match(s) else None


class ChronosClient(jclient.Client):
    """Schedules repeating jobs over the HTTP API; each run logs a
    marker file the final read collects and parses (chronos.clj's
    add-job! / read-runs)."""

    def __init__(self, port: int = 4400, node: str | None = None,
                 timeout: float = 10.0):
        self.port = port
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return ChronosClient(self.port, node, self.timeout)

    def read_runs(self, test) -> list[dict]:
        """All runs from all nodes (chronos.clj:161-170)."""
        runs = []
        for n in test.get("nodes", []):
            sess = control.session(test, n)
            try:
                # \036 (ASCII RS): octal escapes are POSIX printf;
                # \x1e is a bashism dash would emit literally
                out = sess.exec_raw(
                    f"for f in {JOB_DIR}/*; do "
                    "[ -f \"$f\" ] || continue; "
                    "cat \"$f\"; printf '\\036'; done").out
                for rec in out.split("\x1e"):
                    if rec.strip():
                        runs.append(parse_run_file(n, rec))
            finally:
                sess.disconnect()
        return runs

    def invoke(self, test, op):
        crash = "fail" if op["f"] == "read" else "info"
        host, port = resolve(self.node, self.port, test or {})
        try:
            if op["f"] in ("add", "add-job"):
                if op["f"] == "add":   # legacy run-once set workload
                    j = op["value"]
                    body = {"name": f"jepsen-{j}",
                            "command": f"touch /tmp/chronos-run-{j}",
                            "schedule": "R1//PT10S", "epsilon": "PT30S"}
                else:
                    job = op["value"]
                    body = {"name": str(job["name"]),
                            "command": job_command(job),
                            "schedule": job_schedule_str(job),
                            "scheduleTimeZone": "UTC",
                            "epsilon": f"PT{job['epsilon']}S",
                            "mem": 1, "disk": 1, "cpus": 0.001,
                            "async": False}
                body["owner"] = "jepsen@localhost"
                req = urllib.request.Request(
                    f"http://{host}:{port}/scheduler/iso8601",
                    data=json.dumps(body).encode(), method="POST",
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=self.timeout).read()
                return {**op, "type": "ok"}
            if op["f"] == "read":
                if (op.get("value") or {}) == "markers" or \
                        test.get("workload") == "jobs":
                    # legacy set workload: marker filenames only
                    runs = set()
                    for n in test.get("nodes", []):
                        sess = control.session(test, n)
                        try:
                            out = sess.exec_raw(
                                "ls /tmp/ | grep chronos-run- "
                                "|| true").out
                            for line in out.split():
                                runs.add(int(line.rsplit("-", 1)[-1]))
                        finally:
                            sess.disconnect()
                    return {**op, "type": "ok", "value": sorted(runs)}
                return {**op, "type": "ok",
                        "value": self.read_runs(test)}
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except urllib.error.HTTPError as e:
            return {**op, "type": "fail" if 400 <= e.code < 500
                    else crash, "error": f"http-{e.code}"}
        except OSError as e:
            return {**op, "type": crash, "error": str(e)[:160]}


def generator():
    import itertools
    counter = itertools.count()

    def add(test=None, ctx=None):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    return gen.stagger(1.0, add)


def add_job_generator(head_start: float = 10.0):
    """Random repeating jobs (chronos.clj:194-219): interval always
    exceeds duration + epsilon + forgiveness so one job's runs never
    overlap — the premise of the disjoint target windows the checker
    matches against."""
    import itertools
    import random
    import time as _time

    counter = itertools.count(1)

    def add(test=None, ctx=None):
        duration = random.randint(0, 9)
        epsilon = 10 + random.randint(0, 19)
        interval = (1 + duration + epsilon
                    + int(chronos_checker.EPSILON_FORGIVENESS)
                    + random.randint(0, 29))
        return {"type": "invoke", "f": "add-job",
                "value": {"name": next(counter),
                          "start": _time.time() + head_start,
                          "count": 1 + random.randint(0, 98),
                          "duration": duration,
                          "epsilon": epsilon,
                          "interval": interval}}

    return gen.stagger(30.0, add)


def final_read():
    return gen.clients(gen.until_ok(gen.repeat_gen({"f": "read"})))


def workloads(opts: dict | None = None) -> dict:
    return {
        "jobs": lambda: {
            "generator": generator(),
            "checker": jchecker.set_checker()},
        "schedule": lambda: {
            "generator": add_job_generator(),
            "checker": chronos_checker.ChronosChecker()},
    }


def chronos_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wl = opts.get("workload", "schedule")
    spec = workloads(opts)[wl]()
    test = {
        "name": f"chronos {wl}",
        "os": os_setup.debian(),
        "db": ChronosDB(),
        "client": opts.get("client") or ChronosClient(),
        "nemesis": jnemesis.partition_random_halves(),
        "checker": spec["checker"],
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(spec["generator"],
                            nemesis_cycle(
                                opts.get("nemesis-interval", 10)))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            final_read()),
        "workload": wl,
    }
    for k, v in opts.items():
        test.setdefault(k, v)
    return test


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: chronos_test(
            {**tmap,
             "workload": resolve_workload(args, tmap, "schedule")}),
        name="chronos",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())

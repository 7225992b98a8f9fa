"""A Chronos cluster for the chronos suite's client: an HTTP scheduler
that takes jobs, and a dummy remote that serves the run files those
jobs leave on the nodes.

The suite's client schedules jobs with `POST /scheduler/iso8601`
(chronos.clj's add-job!) and reads their runs off the nodes over SSH
(read-runs, chronos.clj:161-170). This fake answers both:

- `FakeChronos.port` is the scheduler. A job of the `schedule`
  workload (`R<count>/<start>/PT<interval>S`, its command naming the
  job and its `sleep <duration>`) runs at each of its targets, LAG s
  late, on the nodes in turn; a legacy run-once job (`jepsen-<j>`,
  `touch /tmp/chronos-run-<j>`) runs as soon as it is added.
- As a remote, the run-file read (`for f in /tmp/chronos-test/*; ...`)
  prints the node's runs that have begun by now, each as `date -u
  -Ins` would have written it (name, start, and end once it is past),
  separated by ASCII RS; the marker listing (`ls /tmp/ | grep
  chronos-run-`) prints the node's markers. Every other command
  succeeds with no output and is recorded, as on a `DummyRemote`.

Standard library and the port's `control` only, so a caller that must
stay jax-free (chip_smoke.py) can load it; its results duck-type as
either package's `control.Result`.

    with FakeChronos() as fake:
        test = chronos.chronos_test({
            "db-hosts": {n: ("127.0.0.1", fake.port) for n in nodes},
            "remote": fake, ...})
"""

from __future__ import annotations

import json
import re
import threading
import time
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from jepsen_tpu_torch.control import DummyRemote, Result

#: How late (s) each run starts after its target: past the millisecond
#: the schedule string truncates, well inside the job's epsilon.
LAG = 0.25
NODES = ("n1", "n2", "n3", "n4", "n5")

_SCHEDULE = re.compile(r"^R(\d+)/([^/]*)/PT(\d+(?:\.\d+)?)S$")
_SLEEP = re.compile(r"sleep (\d+(?:\.\d+)?);")
_MARKER = re.compile(r"touch /tmp/chronos-run-(\d+)")


def _epoch(iso: str) -> float:
    return datetime.fromisoformat(iso.replace("Z", "+00:00")).timestamp()


def date_ins(t: float) -> str:
    """`date -u -Ins`'s rendering of epoch second `t`:
    2026-10-18T08:47:52,123456789+00:00."""
    whole = int(t)
    ns = int(round((t - whole) * 1e9))
    if ns >= 10 ** 9:
        whole, ns = whole + 1, ns - 10 ** 9
    base = datetime.fromtimestamp(whole, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S")
    return f"{base},{ns:09d}+00:00"


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        fake = self.server.owner  # type: ignore[attr-defined]
        n = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
            code = 204 if self.path == "/scheduler/iso8601" \
                and fake.add(body) else 400
        except (ValueError, KeyError):
            code = 400
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()


class FakeChronos(DummyRemote):
    """The scheduler on `port` and the nodes' run files as a remote.
    `jobs` holds each scheduled job as {name, start, count, interval,
    duration, node0}; `markers` each run-once job's number and node."""

    def __init__(self, nodes=NODES):
        super().__init__()
        self.nodes = tuple(nodes)
        self.jobs: list[dict] = []
        self.markers: list[tuple[int, str]] = []
        self.lock = threading.Lock()
        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._srv.daemon_threads = True
        self._srv.owner = self
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def add(self, body: dict) -> bool:
        """Schedule one job from its JSON body; False if it is not one
        this fake knows."""
        m = _MARKER.search(body.get("command", ""))
        with self.lock:
            if m is not None:
                j = int(m.group(1))
                self.markers.append(
                    (j, self.nodes[len(self.markers) % len(self.nodes)]))
                return True
            s = _SCHEDULE.match(body["schedule"])
            d = _SLEEP.search(body.get("command", ""))
            if s is None or d is None:
                return False
            self.jobs.append({
                "name": int(body["name"]), "start": _epoch(s.group(2)),
                "count": int(s.group(1)), "interval": float(s.group(3)),
                "duration": float(d.group(1)),
                "node0": len(self.jobs) % len(self.nodes)})
            return True

    def runs(self, node: str, now: float | None = None) -> list[str]:
        """The run files on `node` at `now`: each run that has begun."""
        now = time.time() if now is None else now
        out = []
        with self.lock:
            jobs = list(self.jobs)
        for j in jobs:
            for k in range(j["count"]):
                start = j["start"] + k * j["interval"] + LAG
                if start > now:
                    break
                if self.nodes[(j["node0"] + k) % len(self.nodes)] != node:
                    continue
                lines = [str(j["name"]), date_ins(start)]
                end = start + j["duration"]
                if end <= now:
                    lines.append(date_ins(end))
                out.append("\n".join(lines) + "\n")
        return out

    def execute(self, spec: dict, cmd: str, stdin: str = "") -> Result:
        self._record(spec["node"], "execute", cmd)
        node = spec["node"]
        if "/tmp/chronos-test/*" in cmd:
            return Result("".join(r + "\x1e" for r in self.runs(node)),
                          "", 0)
        if "grep chronos-run-" in cmd:
            with self.lock:
                mine = [j for j, n in self.markers if n == node]
            return Result("".join(f"chronos-run-{j}\n" for j in mine),
                          "", 0)
        return Result("", "", 0)

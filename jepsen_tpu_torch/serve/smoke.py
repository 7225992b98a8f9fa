"""`python -m jepsen_tpu_torch.serve.smoke [--device cuda|cpu]` — the
port's verdict daemon end to end, the counterpart of the reference's
`make serve-smoke`.

Starts the REAL daemon (`python -m jepsen_tpu_torch.cli serve
--device D`, default cuda, where its folds launch `closure_square`)
as a subprocess over a synthetic store (the port's own synth), drives two concurrent tenants
through the real socket, scrapes `/metrics` while they stream,
SIGTERMs the daemon and asserts the full contract:

  * every streamed verdict is byte-identical (canonical JSON) to the
    post-hoc `analyze-store` verdict for the same history;
  * per-tenant series appear on `/metrics` and the `serve` section in
    health.json names both tenants;
  * SIGTERM drains cleanly (exit 0) with zero lost and zero
    duplicated journal entries — each tenant's journal holds exactly
    its submitted ids, once each;
  * the flight recorder carries the serve_* lifecycle.

Exit 0/1; every failure prints the failing contract.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

B, T, K, BAD_EVERY = 8, 128, 8, 4


def _child_env(store: Path) -> dict:
    env = {**os.environ,
           "JEPSEN_TPU_METRICS_PORT": "0",
           "JEPSEN_TPU_HEALTH_INTERVAL_S": "0.5",
           "JEPSEN_TPU_SERVE_WEIGHTS": "fleetA=2,fleetB=1"}
    for k in ("JEPSEN_TPU_MESH", "JEPSEN_TPU_MESH_SHARD",
              "JEPSEN_TPU_MESH_SHARDS"):
        env.pop(k, None)
    return env


def _read_ready(proc, timeout: float = 180.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError("daemon exited before ready line: "
                               + (proc.stderr.read() or "")[-400:])
        try:
            got = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(got, dict) and "serve" in got:
            return got["serve"]
    raise RuntimeError("timed out waiting for the daemon ready line")


def _scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def _canon(v) -> str:
    return json.dumps(v, sort_keys=True)


def _journal_line_count(path: Path) -> int:
    """Raw line count of a journal file (duplicate detection: the
    deduplicating loader can't see a double-append)."""
    try:
        return sum(1 for ln in path.read_text().splitlines()
                   if ln.strip())
    except OSError:
        return -1


def main(argv: list[str] | None = None) -> int:
    from .. import obs
    from ..checker.elle.synth import write_synth_store
    from ..store import Store, VerdictJournal, tenant_journal_path
    from .client import ServeClient

    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch.serve.smoke")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    failures: list[str] = []

    def check(ok: bool, what: str) -> None:
        print(("ok   " if ok else "FAIL ") + what)
        if not ok:
            failures.append(what)

    tmp = Path(tempfile.mkdtemp(prefix="serve-smoke-"))
    store = tmp / "store"
    (store / "synth").mkdir(parents=True)
    write_synth_store(store / "synth", B, T, K, BAD_EVERY)
    run_dirs = sorted(Store(store).iter_run_dirs())
    assert len(run_dirs) == B

    env = _child_env(store)
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "serve",
         "--store", str(store), "--device", args.device],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready = _read_ready(proc)
        check(ready.get("socket"), "daemon ready on a unix socket")
        mport = ready.get("metrics_port")
        check(bool(mport), "metrics endpoint up")

        halves = {"fleetA": run_dirs[: B // 2],
                  "fleetB": run_dirs[B // 2:]}
        results: dict[str, dict[str, dict]] = {}
        errs: list[str] = []

        def tenant_run(name: str, dirs) -> None:
            try:
                with ServeClient(socket_path=ready["socket"],
                                 tenant=name) as c:
                    for d in dirs:
                        c.check_dir(d)
                    results[name] = c.collect(timeout=300)
            except Exception as e:
                errs.append(f"{name}: {e!r}")

        threads = [threading.Thread(target=tenant_run, args=(n, ds))
                   for n, ds in halves.items()]
        for t in threads:
            t.start()

        # scrape while the tenants stream: loop until the serve series
        # (requests + a per-tenant series) appear, then keep the page
        page = ""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                page = _scrape(mport)
            except OSError:
                page = ""
            if "jepsen_tpu_serve_requests" in page \
                    and "jepsen_tpu_serve_fleetA_" in page:
                break
            time.sleep(0.2)
        check("jepsen_tpu_serve_requests" in page,
              "serve_requests counter on /metrics")
        check("jepsen_tpu_serve_fleetA_" in page
              and "jepsen_tpu_serve_fleetB_" in page,
              "per-tenant series on /metrics")

        for t in threads:
            t.join(timeout=300)
        check(not errs, f"both tenants collected ({errs})")
        check(all(len(results.get(n, {})) == len(ds)
                  for n, ds in halves.items()),
              "every submitted history got a verdict")

        # health.json serve section names both tenants
        health = {}
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                health = json.loads((store / "health.json").read_text())
            except (OSError, json.JSONDecodeError):
                health = {}
            ten = (health.get("serve") or {}).get("tenants") or {}
            if {"fleetA", "fleetB"} <= set(ten):
                break
            time.sleep(0.3)
        ten = (health.get("serve") or {}).get("tenants") or {}
        check({"fleetA", "fleetB"} <= set(ten),
              f"health.json serve section names both tenants ({ten})")

        # graceful drain
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = -9
        check(rc == 0, f"SIGTERM drained cleanly (rc={rc})")

        # zero lost, zero duplicated journal entries
        for name, dirs in halves.items():
            p = tenant_journal_path(store, name)
            entries = VerdictJournal.load(p)
            want = {(str(d), "append") for d in dirs}
            check(set(entries) == want,
                  f"{name} journal holds exactly its ids "
                  f"({len(entries)}/{len(want)})")
            check(_journal_line_count(p) == len(want),
                  f"{name} journal has no duplicate lines")

        # serve_* lifecycle on the flight recorder
        kinds = {e.get("event") for e in obs.load_events(store)}
        check({"serve_start", "serve_tenant_connect", "serve_admit",
               "serve_drain", "serve_stop"} <= kinds,
              f"serve_* events recorded ({sorted(kinds)})")

        # byte-identical to the post-hoc batch path
        p2 = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch.cli", "analyze-store",
             "--store", str(store), "--device", args.device],
            cwd=REPO, env={k: v for k, v in env.items()
                           if k != "JEPSEN_TPU_METRICS_PORT"},
            capture_output=True, text=True, timeout=600)
        check(p2.returncode in (0, 1),
              f"analyze-store swept (rc={p2.returncode})")
        mismatches = []
        for name, dirs in halves.items():
            for d in dirs:
                streamed = results.get(name, {}).get(str(d))
                posthoc = json.loads((d / "results.json").read_text())
                if _canon(streamed) != _canon(posthoc):
                    mismatches.append(str(d))
        check(not mismatches,
              f"streamed verdicts byte-identical to analyze-store "
              f"({len(mismatches)} mismatch(es))")
        invalid = sum(1 for r in results.get("fleetA", {}).values()
                      if r.get("valid?") is False) \
            + sum(1 for r in results.get("fleetB", {}).values()
                  if r.get("valid?") is False)
        check(invalid == B // BAD_EVERY,
              f"invalid histories found ({invalid}/{B // BAD_EVERY})")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    if failures:
        print(f"serve-smoke: {len(failures)} contract(s) FAILED")
        return 1
    print("serve-smoke: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())

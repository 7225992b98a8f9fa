"""`python -m jepsen_tpu_torch.serve.fleet_smoke [--device cuda|cpu]` —
the port's serve fleet under self-nemesis, the counterpart of the
reference's `make fleet-smoke`.

Starts a REAL 3-daemon fleet (the router in-process, each member a
real `python -m jepsen_tpu_torch.cli serve --fleet-instance k --device
D` subprocess; default cuda, where the members' folds launch
`closure_square`) over a synthetic store (the port's own synth) and
drives three tenants through the router socket while a nemesis
schedule — built from the port's `nemesis` combinators (`Nemesis` + `compose`, targets drawn with `split_one`)
— breaks members underneath them:

  * socket partition: the member's unix socket path is renamed aside
    and healed; established streams keep flowing, the beacon stays
    fresh, and the router must NOT bury the member (epoch unchanged);
  * SIGKILL mid-load (the acceptance fault): the affine member of one
    tenant is killed with checks in flight — the router fences the
    epoch, adopts the tenant on a successor, and replays/re-checks;
  * SIGSTOP (hammer): a stopped member still accept()s from the
    kernel backlog, so only beacon STALENESS can convict it — the
    router must declare it dead within JEPSEN_TPU_FLEET_FAILOVER_S
    and STONITH it;
  * clock skew: one member runs under the port's own
    `jepsen_tpu_torch/native/faketime_shim.cc` LD_PRELOAD (built best-effort; the fault is skipped without a
    compiler) with its REALTIME clock an hour ahead and 25 % fast —
    beacon liveness is kernel mtime, so the skewed member must
    survive the whole schedule.

The contract asserted at the end is the fleet invariant:

  * every tenant lands every verdict across both deaths — zero lost;
  * each tenant's journal holds exactly its submitted ids, ONCE each
    (raw line count, so a zombie double-append can't hide behind the
    deduplicating loader) — zero duplicated;
  * a full resubmit of every id after both failovers replays
    byte-identically from the journals (client `replays` > 0);
  * streamed verdicts are byte-identical (canonical JSON) to a
    post-hoc single-process `analyze-store` sweep of the same store;
  * `fleet_*` lifecycle events, `fleet_*` /metrics series, the
    `fleet` section in health.json, and >=1 `fleet-reassign.jsonl`
    line all record what happened.

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
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

B, T, K, BAD_EVERY = 12, 96, 8, 4
TENANTS = ("fleetA", "fleetB", "fleetC")
SKEW_INSTANCE = 2
SKEW_OFFSET_S, SKEW_RATE = 3600.0, 1.25


def _setup_env() -> None:
    os.environ.update({
        "JEPSEN_TPU_METRICS_PORT": "0",
        "JEPSEN_TPU_HEALTH_INTERVAL_S": "0.5",
        # fast heartbeats so both failovers land inside the smoke's
        # budget; the client's retry budget comfortably covers them
        "JEPSEN_TPU_FLEET_HEARTBEAT_S": "0.25",
        "JEPSEN_TPU_FLEET_FAILOVER_S": "2.0",
        "JEPSEN_TPU_SERVE_RETRY_S": "120",
    })
    for k in ("JEPSEN_TPU_MESH", "JEPSEN_TPU_MESH_SHARD",
              "JEPSEN_TPU_MESH_SHARDS", "JEPSEN_TPU_SERVE_SOCKET",
              "JEPSEN_TPU_SERVE_PORT"):
        os.environ.pop(k, None)


def _build_shim(tmp: Path) -> Path | None:
    """Best-effort local build of the port's faketime LD_PRELOAD shim
    (the node-side recipe of the port's `faketime`, run here)."""
    src = REPO / "jepsen_tpu_torch" / "native" / "faketime_shim.cc"
    so = tmp / "libfaketime_shim.so"
    try:
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-pthread",
             "-o", str(so), str(src), "-ldl"],
            check=True, capture_output=True, timeout=180)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def _scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def _canon(v) -> str:
    return json.dumps(v, sort_keys=True)


def _journal_line_count(path: Path) -> int:
    """Raw line count (duplicate detection: the deduplicating loader
    can't see a double-append)."""
    try:
        return sum(1 for ln in path.read_text().splitlines()
                   if ln.strip())
    except OSError:
        return -1


def main(argv: list[str] | None = None) -> int:  # noqa: C901 - a linear acceptance script
    from .. import nemesis, obs
    from ..checker.elle.synth import write_synth_store
    from ..store import Store, VerdictJournal, tenant_journal_path
    from . import fleet as fleet_mod
    from .client import ServeClient

    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.serve.fleet_smoke")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    _setup_env()

    failures: list[str] = []

    def check(ok: bool, what: str) -> None:
        print(("ok   " if ok else "FAIL ") + what)
        if not ok:
            failures.append(what)

    # -- the self-nemesis: local faults through the combinator layer --
    class ProcSignalNemesis(nemesis.Nemesis):
        """SIGKILL / SIGSTOP / SIGCONT a fleet member by pid."""
        fs = frozenset({"kill", "pause", "resume"})
        SIGS = {"kill": signal.SIGKILL, "pause": signal.SIGSTOP,
                "resume": signal.SIGCONT}

        def invoke(self, test, op):
            try:
                os.kill(int(op["value"]), self.SIGS[op["f"]])
            except ProcessLookupError:
                return {**op, "type": "info", "value": "gone"}
            return {**op, "type": "info"}

    class SocketPartitionNemesis(nemesis.Nemesis):
        """Partition a member's socket from NEW connections by moving
        the path aside; established streams keep flowing."""
        fs = frozenset({"partition", "heal"})

        def invoke(self, test, op):
            p = Path(op["value"])
            if op["f"] == "partition":
                p.rename(p.with_suffix(".partitioned"))
            else:
                p.with_suffix(".partitioned").rename(p)
            return {**op, "type": "info"}

    nem = nemesis.compose([ProcSignalNemesis(),
                           SocketPartitionNemesis()])
    test: dict = {"nodes": []}
    nem.setup(test)

    tmp = Path(tempfile.mkdtemp(prefix="fleet-smoke-"))
    store = tmp / "store"
    (store / "synth").mkdir(parents=True)
    write_synth_store(store / "synth", B, T, K, BAD_EVERY)
    run_dirs = sorted(Store(store).iter_run_dirs())
    assert len(run_dirs) == B
    per = B // len(TENANTS)
    dirs = {t: run_dirs[i * per:(i + 1) * per]
            for i, t in enumerate(TENANTS)}

    shim = _build_shim(tmp)
    member_env = {}
    if shim is not None:
        member_env[SKEW_INSTANCE] = {
            "LD_PRELOAD": str(shim),
            "JEPSEN_FAKETIME_OFFSET_S": str(SKEW_OFFSET_S),
            "JEPSEN_FAKETIME_RATE": str(SKEW_RATE)}
        print(f"ok   clock-skew fault armed on d{SKEW_INSTANCE} "
              f"(+{SKEW_OFFSET_S:.0f}s, x{SKEW_RATE})")
    else:
        print("SKIP clock-skew fault (no compiler for the shim)")

    router = fleet_mod.FleetRouter(Store(store), daemons=3,
                                   member_env=member_env,
                                   device=args.device)
    clients: dict[str, ServeClient] = {}
    want: dict[str, dict[str, dict]] = {t: {} for t in TENANTS}
    try:
        router.start()
        ready = router.ready_info()["fleet"]
        check(ready["daemons"] == 3 and ready["epoch"] == 1,
              f"3-daemon fleet up at epoch 1 ({ready['daemons']}, "
              f"epoch {ready['epoch']})")
        mport = ready.get("metrics_port")
        check(bool(mport), "router metrics endpoint up")

        for t in TENANTS:
            c = ServeClient(socket_path=ready["socket"], tenant=t)
            c.connect(retry=True)
            clients[t] = c

        # -- wave 1: a clean half-load on the healthy fleet ----------
        for t in TENANTS:
            for d in dirs[t][: per // 2]:
                clients[t].check_dir(d)
        for t in TENANTS:
            got = clients[t].collect(timeout=300, reconnect=True)
            want[t].update(got)
        check(all(len(want[t]) == per // 2 for t in TENANTS),
              "wave 1: every tenant landed its verdicts")

        page = ""
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                page = _scrape(mport)
            except OSError:
                page = ""
            if "jepsen_tpu_fleet_daemons_live" in page:
                break
            time.sleep(0.2)
        check("jepsen_tpu_fleet_daemons_live" in page,
              "fleet gauges on the router /metrics")

        # -- fault 1: socket partition, healed — NOT a death ---------
        live = router._live_members()
        loner = nemesis.split_one([m.instance for m in live])[0][0]
        sock = router._member(loner).socket_path
        nem.invoke(test, {"f": "partition", "value": str(sock)})
        time.sleep(1.0)       # several monitor scans with it severed
        nem.invoke(test, {"f": "heal", "value": str(sock)})
        time.sleep(0.5)
        check(router._member(loner).status == "live"
              and router._epoch == 1,
              f"partitioned d{loner} not buried while its beacon "
              f"stayed fresh (epoch {router._epoch})")

        # -- fault 2: SIGKILL the affine member of fleetA MID-LOAD ---
        for t in TENANTS:
            for d in dirs[t][per // 2:]:
                clients[t].check_dir(d)
        kill_m = router._affine(TENANTS[0], router._live_members())
        nem.invoke(test, {"f": "kill", "value": kill_m.current_pid()})
        for t in TENANTS:
            got = clients[t].collect(timeout=300, reconnect=True)
            want[t].update(got)
        check(all(len(want[t]) == per for t in TENANTS),
              f"SIGKILL d{kill_m.instance} mid-load: every tenant "
              "still landed every verdict")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline \
                and router._member(kill_m.instance).status != "dead":
            time.sleep(0.1)
        check(router._member(kill_m.instance).status == "dead"
              and router._epoch == 2,
              f"router convicted d{kill_m.instance} and fenced "
              f"epoch -> {router._epoch}")

        # -- fault 3: SIGSTOP another member (beacon staleness) ------
        live = [m for m in router._live_members()]
        hammer = next((m for m in live
                       if m.instance != SKEW_INSTANCE), live[0])
        nem.invoke(test, {"f": "pause",
                          "value": hammer.current_pid()})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and router._member(hammer.instance).status != "dead":
            time.sleep(0.1)
        check(router._member(hammer.instance).status == "dead"
              and router._epoch == 3,
              f"SIGSTOPped d{hammer.instance} convicted on beacon "
              f"staleness (epoch {router._epoch})")
        nem.invoke(test, {"f": "resume",
                          "value": hammer.current_pid()})

        if SKEW_INSTANCE in member_env \
                and SKEW_INSTANCE not in (kill_m.instance,
                                          hammer.instance):
            check(router._member(SKEW_INSTANCE).status == "live",
                  f"clock-skewed d{SKEW_INSTANCE} never falsely "
                  "buried (liveness is kernel mtime)")

        # -- wave 3: full resubmit replays from the journals ---------
        for t in TENANTS:
            for d in dirs[t]:
                clients[t].check_dir(d)
        replays_ok, byte_ok = True, True
        for t in TENANTS:
            got = clients[t].collect(timeout=300, reconnect=True)
            replays_ok &= clients[t].replays > 0
            for d in dirs[t]:
                if _canon(got.get(str(d))) != _canon(
                        want[t].get(str(d))):
                    byte_ok = False
        check(replays_ok, "post-failover resubmits replayed from "
                          "the journals")
        check(byte_ok, "replayed verdicts byte-identical to the "
                       "originals")

        # -- observability surfaces ----------------------------------
        try:
            page = _scrape(mport)
        except OSError:
            page = ""
        # (fleet_replayed_verdicts only materializes when a failover
        # resend hits an already-journaled id — a race the schedule
        # doesn't pin down — so only the guaranteed series are asserted)
        check("jepsen_tpu_fleet_failovers" in page
              and "jepsen_tpu_fleet_epoch" in page,
              "failover + epoch series on /metrics")

        health = {}
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                health = json.loads(
                    (store / "health.json").read_text())
            except (OSError, json.JSONDecodeError):
                health = {}
            if (health.get("fleet") or {}).get("epoch") == 3:
                break
            time.sleep(0.3)
        fl = health.get("fleet") or {}
        dead = sorted(k for k, m in (fl.get("members") or {}).items()
                      if m.get("status") == "dead")
        check(fl.get("epoch") == 3 and len(dead) == 2,
              f"health.json fleet section: epoch {fl.get('epoch')}, "
              f"dead members {dead}")

        reassigns = fleet_mod.load_reassignments(store)
        check(len(reassigns) >= 1
              and all(r["dead"] != r["successor"]
                      for r in reassigns),
              f"fleet-reassign.jsonl records the moves "
              f"({len(reassigns)} line(s))")

        for c in clients.values():
            c.close()
        clients.clear()
        rc = router.stop()
        check(rc == 0, f"router stopped cleanly (rc={rc})")

        # -- the invariant: zero lost, zero duplicated ---------------
        for t in TENANTS:
            p = tenant_journal_path(store, t)
            entries = VerdictJournal.load(p)
            ids = {(str(d), "append") for d in dirs[t]}
            check(set(entries) == ids,
                  f"{t} journal holds exactly its ids "
                  f"({len(entries)}/{len(ids)})")
            check(_journal_line_count(p) == len(ids),
                  f"{t} journal has no duplicate lines across "
                  "the failovers")

        kinds = {e.get("event") for e in obs.load_events(store)}
        need = {"fleet_start", "fleet_daemon_up", "fleet_daemon_dead",
                "fleet_failover", "fleet_stop"}
        check(need <= kinds,
              f"fleet_* lifecycle events recorded ({sorted(kinds & need)})")

        # -- byte parity with the post-hoc batch path ----------------
        env = {k: v for k, v in os.environ.items()
               if k != "JEPSEN_TPU_METRICS_PORT"}
        p2 = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch.cli", "analyze-store",
             "--store", str(store), "--device", args.device],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=600)
        check(p2.returncode in (0, 1),
              f"analyze-store swept (rc={p2.returncode})")
        mismatches = [str(d) for t in TENANTS for d in dirs[t]
                      if _canon(want[t].get(str(d))) != _canon(
                          json.loads((d / "results.json").read_text()))]
        check(not mismatches,
              f"fleet verdicts byte-identical to analyze-store "
              f"({len(mismatches)} mismatch(es))")
        invalid = sum(1 for t in TENANTS
                      for r in want[t].values()
                      if r.get("valid?") is False)
        check(invalid == B // BAD_EVERY,
              f"invalid histories found ({invalid}/{B // BAD_EVERY})")
    finally:
        for c in clients.values():
            try:
                c.close()
            except Exception:
                pass
        router.stop()
        nem.teardown(test)
        shutil.rmtree(tmp, ignore_errors=True)

    if failures:
        print(f"fleet-smoke: {len(failures)} contract(s) FAILED")
        return 1
    print("fleet-smoke: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())

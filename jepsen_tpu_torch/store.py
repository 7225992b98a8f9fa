"""The on-disk store of test runs: the part of `jepsen_tpu/store.py` the
test runner, the batch sweep and the store browser (`web.py`) read and
write.

Layout (the reference's `store/<test-name>/<start-time>/`):

    store/<test-name>/<start-time>/
        history.jsonl   one op per line (preferred); `save_1` writes
                        it and history.edn before analysis
        history.edn     the same ops as EDN (fallback)
        test.json       the serializable test map (the reference's own
                        stores: test.fressian)
        results.json    verdict written by analyze-store
        results.edn     the same verdict as EDN
        .sweep-<checker>  resume marker with the verdict's validity
        latest          link to the newest run of this test name
    store/latest, store/current  links to the newest run
    store/verdicts.jsonl  one line per verdict, appended as it lands
    store/trace.json, metrics.json  the sweep's timeline and metrics
    store/events.jsonl  the sweep's lifecycle events, flushed as they land
    store/report.json, report.md  the attribution report (--report)
    store/analytics.jsonl  per-history search stats
                        (JEPSEN_TPU_KERNEL_STATS)
    store/costdb.jsonl  per-(kernel flags, geometry) device cost records
                        (JEPSEN_TPU_COSTDB)
    store/plan.json     the planner's fitted model (JEPSEN_TPU_PLANNER)
    store/health.json   the live health snapshot
                        (JEPSEN_TPU_HEALTH_INTERVAL_S)
    store/<test-name>/<start-time>/encoded.v2.bin (list-append) and
        encoded-wr.v1.bin (rw-register)  the encoded sidecar cache
                        (JEPSEN_TPU_ENCODE_CACHE*, JEPSEN_TPU_SIDECAR_V2)
    store/serve.sock, serve.pid, serve-<tenant>.verdicts.jsonl,
        serve-requests.jsonl  the verdict daemon's socket, pidfile,
                        per-tenant journals and admission spool
    store/fleet.sock, fleet-d<k>.sock, fleet-d<k>.json,
        fleet-epoch.json, fleet-reassign.jsonl  the serve fleet's
                        router socket, member sockets and beacons, the
                        membership epoch (the fence) and the
                        reassignment journal
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from pathlib import Path
from typing import Any

from . import edn
from . import history as h
from .util import chunk_vec, real_pmap

log = logging.getLogger(__name__)

# Keys of a test map that never serialize (functions, live
# connections...).
NONSERIALIZABLE_KEYS = (
    "db", "os", "net", "client", "checker", "nemesis", "generator", "model",
    "remote", "store", "logging", "barrier", "sessions", "args",
)

DEFAULT_BASE = "store"

# Histories longer than this render in chunks on threads (write_history).
PARALLEL_WRITE_THRESHOLD = 16384


def _stringify(v: Any) -> Any:
    """Best-effort conversion of a test-map value to JSON-compatible data."""
    if isinstance(v, dict):
        return {str(k): _stringify(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_stringify(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted((_stringify(x) for x in v), key=repr)
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, datetime.datetime):
        return v.isoformat()
    return repr(v)


def load_history_dir(run_dir: str | os.PathLike) -> list[h.Op]:
    """History ops from a run dir: history.jsonl preferred,
    history.edn fallback."""
    d = Path(run_dir)
    jl = d / "history.jsonl"
    if jl.exists():
        # one json.loads over a joined array is much faster than one
        # loads per line
        lines = [ln for ln in jl.read_text().splitlines() if ln.strip()]
        if not lines:
            return []
        return json.loads("[" + ",".join(lines) + "]")
    ed = d / "history.edn"
    if ed.exists():
        return h.history_from_edn(ed.read_text())
    raise FileNotFoundError(f"no history in {d}")


class Store:
    """A store rooted at `base` (default ./store)."""

    def __init__(self, base: str | os.PathLike = DEFAULT_BASE):
        self.base = Path(base)

    # -- paths ------------------------------------------------------------

    def test_dir(self, test: dict) -> Path:
        name = test.get("name", "noname")
        start = test.get("start-time")
        if start is None:
            start = datetime.datetime.now().strftime("%Y%m%dT%H%M%S.%f")[:-3]
            test["start-time"] = start
        return self.base / name / str(start)

    def path(self, test: dict, *parts: str) -> Path:
        p = self.test_dir(test).joinpath(*parts)
        p.parent.mkdir(parents=True, exist_ok=True)
        return p

    # -- symlinks ---------------------------------------------------------

    def _relink(self, link: Path, target: Path) -> None:
        link.parent.mkdir(parents=True, exist_ok=True)
        if link.is_symlink() or link.exists():
            # Only move forward: re-analyzing an OLD run (analyze-store's
            # sweep) must not steal latest/current from a newer run.
            try:
                if link.resolve().name > target.name:
                    return
            except OSError:
                pass
            link.unlink()
        link.symlink_to(os.path.relpath(target, link.parent))

    def update_symlinks(self, test: dict) -> None:
        """Point `<base>/<name>/latest`, `<base>/latest` and
        `<base>/current` at this test's run dir (relative links)."""
        d = self.test_dir(test)
        self._relink(d.parent / "latest", d)
        self._relink(self.base / "latest", d)
        self._relink(self.base / "current", d)

    # -- writes -----------------------------------------------------------

    def write_history(self, test: dict) -> None:
        """history.edn and history.jsonl of the test's history; a long
        one renders in chunks on threads, to the same bytes."""
        hist = test.get("history", [])
        d = self.test_dir(test)
        d.mkdir(parents=True, exist_ok=True)
        if len(hist) > PARALLEL_WRITE_THRESHOLD:
            chunks = chunk_vec(PARALLEL_WRITE_THRESHOLD, hist)
            parts = real_pmap(
                lambda c: (h.history_to_edn(c),
                           "".join(json.dumps(_stringify(o)) + "\n"
                                   for o in c)),
                chunks)
            with open(d / "history.edn", "w") as fe, \
                 open(d / "history.jsonl", "w") as fj:
                for e_part, j_part in parts:
                    fe.write(e_part)
                    fj.write(j_part)
        else:
            (d / "history.edn").write_text(
                h.history_to_edn(hist) if hist else "")
            (d / "history.jsonl").write_text(
                "".join(json.dumps(_stringify(o)) + "\n" for o in hist))

    def write_test(self, test: dict) -> None:
        t = {k: _stringify(v) for k, v in test.items()
             if k not in NONSERIALIZABLE_KEYS
             and k not in ("history", "results")}
        p = self.path(test, "test.json")
        p.write_text(json.dumps(t, indent=2, default=repr))

    def write_results(self, test: dict) -> None:
        res = test.get("results", {})
        self.path(test, "results.json").write_text(
            json.dumps(_stringify(res), indent=2, default=repr))
        self.path(test, "results.edn").write_text(
            edn.dumps(_results_to_edn(res)) + "\n")

    def write_trace(self, test: dict) -> Path | None:
        """Persist the current run tracer's `trace.json` (Chrome
        trace-event format) and `metrics.json` next to the results. No-op
        (returns None) when tracing is off (JEPSEN_TPU_TRACE=0 /
        --no-trace), or when the current tracer is sweep-scoped (an
        analyze-store sweep re-analyzes runs under its own tracer, which
        only the sweep exports, once)."""
        from . import trace
        t = trace.get_current()
        if not getattr(t, "enabled", False) \
                or getattr(t, "scope", "run") != "run":
            return None
        d = self.test_dir(test)
        d.mkdir(parents=True, exist_ok=True)
        p = t.export(d / "trace.json")
        t.export_metrics(d / "metrics.json")
        return p

    def save_1(self, test: dict) -> dict:
        """Persist test.json and the history before analysis, so a run
        whose analysis crashes still leaves its history."""
        self.write_test(test)
        self.write_history(test)
        self.update_symlinks(test)
        return test

    def save_2(self, test: dict) -> dict:
        """Persist results (after analysis): test.json, results.json and
        .edn, the run's trace and metrics (`write_trace`; a failed export
        is a warning, never a lost verdict), and the links."""
        self.write_test(test)
        self.write_results(test)
        try:
            self.write_trace(test)
        except Exception:
            log.warning("trace/metrics export failed", exc_info=True)
        self.update_symlinks(test)
        return test

    # -- reads ------------------------------------------------------------

    def tests(self) -> dict[str, dict[str, Path]]:
        """Map of test-name -> {start-time -> dir} (store.clj:275)."""
        out: dict[str, dict[str, Path]] = {}
        if not self.base.exists():
            return out
        for name_dir in sorted(self.base.iterdir()):
            if not name_dir.is_dir() or name_dir.name in ("latest", "current"):
                continue
            runs = {d.name: d for d in sorted(name_dir.iterdir())
                    if d.is_dir() and d.name != "latest"}
            if runs:
                out[name_dir.name] = runs
        return out

    def iter_run_dirs(self, name: str | None = None,
                      shard: int | None = None, n_shards: int = 1):
        """Run dirs `<base>/<name>/<run>` in sorted order, one
        `os.scandir` per directory; with `name`, only that test name's
        runs. The `latest`/`current` links are skipped by name, as the
        reference's walk does. With `shard`/`n_shards`, only the dirs
        whose key `<name>/<run>` lands on `shard` under `shard_of`: the
        mesh sweep's partition, the reference's to the byte, which
        every host derives from its own listing."""
        base = self.base
        try:
            with os.scandir(base) as it:
                names = sorted(
                    e.name for e in it
                    if e.name not in ("latest", "current")
                    and e.is_dir())
        except OSError:
            return
        for nm in names:
            if name is not None and nm != name:
                continue
            try:
                with os.scandir(base / nm) as it:
                    runs = sorted(
                        e.name for e in it
                        if e.name != "latest" and e.is_dir())
            except OSError:
                continue
            for rn in runs:
                if shard is not None \
                        and shard_of(f"{nm}/{rn}", n_shards) != shard:
                    continue
                yield base / nm / rn

    def all_run_dirs(self) -> list[Path]:
        return list(self.iter_run_dirs())

    def latest(self) -> Path | None:
        """The run `<base>/latest` points at, else the run dir with the
        greatest name (its start time) across all test names."""
        link = self.base / "latest"
        if link.exists():
            return link.resolve()
        dirs = self.all_run_dirs()
        return max(dirs, key=lambda d: d.name) if dirs else None

    def load_test(self, run_dir: str | os.PathLike) -> dict:
        """Load a run dir: the port's and the reference's (test.json)
        or the Clojure reference's (test.fressian)."""
        # Resolve symlinks (latest/current) so the dir name below is the
        # real timestamp, not "latest" — re-linking against the link name
        # would create a self-loop.
        d = Path(run_dir).resolve()
        test: dict = {}
        tj = d / "test.json"
        tf = d / "test.fressian"
        if tj.exists():
            test = json.loads(tj.read_text())
        elif tf.exists():
            from . import fressian
            raw = fressian.load_test(tf)
            if isinstance(raw, dict):
                # Map keys are edn.Keyword, which subclasses str and
                # equals its bare name — str() normalizes them.
                test = {str(k): v for k, v in raw.items()}
        # The run dir is authoritative for name/start-time so re-analysis
        # writes back into the SAME dir, whatever form the serialized
        # test map stored them in.
        test["start-time"] = d.name
        test.setdefault("name", d.parent.name)
        test["history"] = load_history_dir(d)
        rj = d / "results.json"
        if rj.exists():
            try:
                test["results"] = json.loads(rj.read_text())
            except (OSError, json.JSONDecodeError):
                # results are a derived artifact: a write truncated by
                # a crash must not make the run unloadable (re-analysis
                # regenerates it)
                pass
        return test

    def load_results(self, run_dir: str | os.PathLike) -> dict | None:
        d = Path(run_dir)
        rj = d / "results.json"
        if rj.exists():
            try:
                return json.loads(rj.read_text())
            except (OSError, json.JSONDecodeError):
                pass
        re_ = d / "results.edn"
        if re_.exists():
            v = edn.loads(re_.read_text())
            return v if isinstance(v, dict) else None
        return None


class VerdictJournal:
    """Append-only per-history verdict log (`verdicts.jsonl`), one
    flushed line per verdict: {"dir" (relative to the store), "checker",
    "valid?"}, plus "quarantined" and "error" for a quarantined run.
    `analyze-store --resume` loads it back (`load`) and skips every
    journaled (dir, checker) pair. Writes are best-effort: a read-only
    store must not sink the sweep."""

    def __init__(self, path: str | os.PathLike,
                 base: str | os.PathLike | None = None):
        self.path = Path(path)
        self.base = Path(base) if base is not None else None
        self._f = None

    def rel(self, run_dir) -> str:
        """The journal's key for a run dir: relative to the store base
        when one is set."""
        if self.base is not None:
            try:
                return os.path.relpath(run_dir, self.base)
            except ValueError:
                pass
        return str(run_dir)

    def record(self, run_dir, checker: str, res: dict,
               full: bool = False) -> bool:
        """Append one verdict line; True when it landed. With `full`
        the whole result rides the line (`"result"`): the serve
        daemon's replay record, from which a reconnecting tenant gets
        its verdict back byte for byte. Sweep journals stay lean."""
        entry = {"dir": self.rel(run_dir), "checker": checker,
                 "valid?": res.get("valid?")}
        for k in ("quarantined", "error"):
            if k in res:
                entry[k] = res[k]
        if full:
            entry["result"] = res
        try:
            if self._f is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                self._f = open(self.path, "a")
                # seal a crash-torn tail so this record starts its own line
                if self._f.tell() > 0:
                    with open(self.path, "rb") as rf:
                        rf.seek(-1, os.SEEK_END)
                        torn = rf.read(1) != b"\n"
                    if torn:
                        self._f.write("\n")
                        from .obs import events
                        events.emit("journal_seal", path=str(self.path))
            self._f.write(json.dumps(entry) + "\n")
            self._f.flush()
            return True
        except (OSError, TypeError, ValueError):
            log.debug("verdict journal append failed for %s", self.path,
                      exc_info=True)
            return False

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    @staticmethod
    def load(path: str | os.PathLike) -> dict[tuple[str, str], dict]:
        """{(dir, checker): last entry} from an existing journal;
        unparseable lines (the crash-truncated tail) are skipped."""
        out: dict[tuple[str, str], dict] = {}
        p = Path(path)
        if not p.is_file():
            return out
        try:
            lines = p.read_text().splitlines()
        except OSError:
            return out
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                e = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if isinstance(e, dict) and "dir" in e and "checker" in e:
                out[(str(e["dir"]), str(e["checker"]))] = e
        return out


# ---------------------------------------------------------------------------
# The verdict service's files, flat at the store root (the reference's
# names, so either package's daemon serves and replays the other's
# journals):
#
#   serve.sock                     the tenant socket (unix mode)
#   serve.pid                      the daemon's pidfile (atomic marker)
#   serve-<tenant>.verdicts.jsonl  per-tenant verdict journal, one FULL
#                                  verdict per line (the replay record)
#   serve-requests.jsonl           admitted-request spool (triage for a
#                                  crashed daemon; cleared at start)
#
# and the fleet's (all N daemons share one store, so a successor
# replays a dead peer's journals directly):
#
#   fleet.sock            the router's tenant-facing socket
#   fleet-d<k>.sock       daemon k's own socket (router-facing)
#   fleet-d<k>.json       daemon k's beacon, atomically replaced every
#                         heartbeat: liveness from its mtime, load from
#                         its payload
#   fleet-epoch.json      the membership epoch marker (the fence)
#   fleet-reassign.jsonl  one line per failover move
# ---------------------------------------------------------------------------

def safe_tenant(name: str) -> str:
    """A tenant id as a filesystem-safe slug: the journal path embeds
    it, so a tenant must not name itself `../../etc`, nor collide with
    another after mangling (hence the hash suffix whenever anything was
    replaced). Dots are mangled too, so no `..` survives."""
    cleaned = "".join(c if c.isalnum() or c in "-_" else "_"
                      for c in str(name))[:64] or "tenant"
    if cleaned != str(name):
        h = xxh64(str(name).encode()) & 0xffffffff
        cleaned = f"{cleaned}-{h:08x}"
    return cleaned


def serve_socket_path(store_base) -> Path:
    """The daemon's unix socket (JEPSEN_TPU_SERVE_SOCKET overrides)."""
    return Path(store_base) / "serve.sock"


def serve_pid_path(store_base) -> Path:
    return Path(store_base) / "serve.pid"


def tenant_journal_path(store_base, tenant: str) -> Path:
    """One tenant's verdict journal: the daemon's crash evidence and
    the tenant's resume evidence (a reconnect replays from it without
    re-checking)."""
    return Path(store_base) / f"serve-{safe_tenant(tenant)}.verdicts.jsonl"


def request_spool_path(store_base) -> Path:
    """The admitted-request spool: one line per admission, so a
    post-mortem on a killed daemon can tell admitted-but-unverdicted
    work from never-admitted work."""
    return Path(store_base) / "serve-requests.jsonl"


def fleet_socket_path(store_base) -> Path:
    """The fleet router's tenant-facing unix socket."""
    return Path(store_base) / "fleet.sock"


def fleet_daemon_socket_path(store_base, instance: int) -> Path:
    """Fleet daemon `instance`'s own listening socket."""
    return Path(store_base) / f"fleet-d{int(instance)}.sock"


def fleet_member_path(store_base, instance: int) -> Path:
    """Fleet daemon `instance`'s beacon file."""
    return Path(store_base) / f"fleet-d{int(instance)}.json"


def fleet_epoch_path(store_base) -> Path:
    """The fleet membership epoch marker: the zombie fence."""
    return Path(store_base) / "fleet-epoch.json"


def fleet_reassign_path(store_base) -> Path:
    """The router's tenant-reassignment journal (failover evidence)."""
    return Path(store_base) / "fleet-reassign.jsonl"


def shard_of(key: str, n_shards: int) -> int:
    """Deterministic shard of a key (a fleet tenant, a mesh run key):
    xxh64 of its UTF-8 bytes modulo `n_shards`, independent of
    PYTHONHASHSEED, so a tenant hashes to the same member in both
    packages. Computed in Python (`xxh64`): a key is short, and the
    router runs without the native library."""
    if n_shards <= 1:
        return 0
    return xxh64(str(key).encode()) % n_shards


# ---------------------------------------------------------------------------
# The cost database: costdb.jsonl at the store root.
#
# The device cost observatory (obs/device.py, behind JEPSEN_TPU_COSTDB)
# keeps one record per (kernel flags, bucket geometry): the dispatches'
# closure_square work counted from their shapes, joined with their
# device windows, appended here at sweep end, one flushed JSON line
# each, so a torn tail from a killed flush is skipped on load. Shards
# of a mesh sweep write `costdb-shard<k>.jsonl`, which the coordinator
# merges (`mesh.merge_costdbs`, through `obs.device.merge_records`).
# The file is the planner's training data (planner.py): append-only,
# consumers dedup by record key. The line
# schema is the reference's, so either package reads the other's file.
# ---------------------------------------------------------------------------

COSTDB_NAME = "costdb.jsonl"


def costdb_path(store_base, shard: int | None = None) -> Path:
    """The costdb of a store (`costdb-shard<k>.jsonl` for a shard)."""
    if shard is None:
        return Path(store_base) / COSTDB_NAME
    return Path(store_base) / f"costdb-shard{shard}.jsonl"


def append_costdb(path, records: list[dict]) -> int:
    """Append cost records to a costdb (`_append_jsonl`)."""
    return _append_jsonl(path, records, "costdb")


class CostTable(list):
    """A costdb read: the record dicts plus which path was read and
    whether that file existed. A list, so a missing or empty costdb is
    a falsy table, never an exception."""

    __slots__ = ("path", "exists")

    def __init__(self, records=(), *, path=None, exists: bool = False):
        super().__init__(records)
        self.path = Path(path) if path is not None else None
        self.exists = bool(exists)

    @property
    def empty(self) -> bool:
        """No records: the planner's cold-start predicate (an absent
        file and a present but recordless one both count)."""
        return not self


def load_costdb(path) -> CostTable:
    """Records from a costdb (a file, or a store directory) as a
    `CostTable`, in file order; unparseable lines (the crash-torn tail)
    and lines without a geometry are skipped. A missing or unreadable
    file gives an empty table with `exists=False`."""
    out: list[dict] = []
    p = Path(path)
    if p.is_dir():
        p = p / COSTDB_NAME
    if not p.is_file():
        return CostTable(path=p, exists=False)
    try:
        lines = p.read_text().splitlines()
    except OSError:
        return CostTable(path=p, exists=False)
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "geometry" in rec:
            out.append(rec)
    return CostTable(out, path=p, exists=True)


#: The planner's fitted model (`JEPSEN_TPU_PLANNER`, planner.py),
#: published whole by temp file and rename.
PLAN_NAME = "plan.json"


def plan_path(store_base) -> Path:
    """The planner's model snapshot of a store; `JEPSEN_TPU_PLANNER_PATH`
    overrides it (one plan shared across stores)."""
    from . import gates
    override = gates.get("JEPSEN_TPU_PLANNER_PATH")
    if override:
        return Path(override)
    return Path(store_base) / PLAN_NAME


#: The analytics ledger's file name (`JEPSEN_TPU_KERNEL_STATS`).
ANALYTICS_NAME = "analytics.jsonl"


def analytics_path(store_base, shard: int | None = None) -> Path:
    """The analytics ledger of a store (`analytics-shard<k>.jsonl` for a
    shard of a multi-host sweep, as the reference names it)."""
    if shard is None:
        return Path(store_base) / ANALYTICS_NAME
    return Path(store_base) / f"analytics-shard{shard}.jsonl"


def _append_jsonl(path, records: list[dict], what: str) -> int:
    """Append records as JSON lines, each flushed as written; a
    crash-torn tail from a previous writer is sealed first (the
    journal's rule: appending after a line that lost its newline would
    merge two records into one unparseable line). Best-effort: a
    read-only store returns 0, never raises."""
    p = Path(path)
    n = 0
    try:
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a") as f:
            if f.tell() > 0:
                with open(p, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        f.write("\n")
            for rec in records:
                try:
                    line = json.dumps(rec)
                except (TypeError, ValueError):
                    continue
                f.write(line + "\n")
                f.flush()
                n += 1
    except OSError:
        log.debug("%s append failed for %s", what, p, exc_info=True)
    return n


def append_analytics(path, records: list[dict]) -> int:
    """Append stats records to an analytics ledger (`_append_jsonl`)."""
    return _append_jsonl(path, records, "analytics")


def load_analytics(path) -> list[dict]:
    """Records from an existing analytics ledger (a file, or a store
    directory), in file order; unparseable lines (the crash-torn tail)
    are skipped, as `VerdictJournal.load` skips them."""
    out: list[dict] = []
    p = Path(path)
    if p.is_dir():
        p = p / ANALYTICS_NAME
    if not p.is_file():
        return out
    try:
        lines = p.read_text().splitlines()
    except OSError:
        return out
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "checker" in rec:
            out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Persistent encoded cache: encoded.v1.bin / encoded.v2.bin sidecars.
#
# The reference's (`jepsen_tpu/store.py`), byte for byte: each
# successful lean encode leaves a flat binary sidecar next to
# history.jsonl, tensors laid out raw, so a warm sweep maps them back as
# zero-copy numpy views and skips the parse. The cache key is the
# history file's (size, mtime_ns, xxh64 over its first and last 64 KiB):
# any growth, rewrite or touch invalidates (the sidecar is then ignored
# and overwritten by the next encode). The native encoder
# (csrc/hist_encode.cc, jt_ha_write_sidecar) writes the same layout
# straight from its own buffers.
#
# v2 (dispatch-shaped, append checker only): the same container, the
# tensors the batch packer feeds the device persisted pre-padded to the
# geometry a one-history bucket would get (kernels.BatchShape.plan: txn
# axis to a multiple of 128, the others to 8), with the effective
# completion keys precomputed. A warm bucket whose histories all carry
# such views is stacked from them with no per-history repack
# (kernels.pack_batch_views; `warm_copy_bytes` counts what a warm
# history still costs in copies otherwise). The lean arrays are slices
# of the padded ones. v1 sidecars stay readable and upgrade to v2 in
# place on first warm load (`sidecar_upgrades` counter + a
# `cache_rebuild` event); the wr checker keeps v1.
# ---------------------------------------------------------------------------

ENCODED_MAGIC = b"JTENC01\n"
ENCODED_MAGIC_V2 = b"JTENC02\n"

#: The dispatch-padding multiples — they mirror kernels.BatchShape.plan
#: (txn axis 128, everything else 8).
_PAD_TXNS = 128
_PAD_MINOR = 8


def _pad_up(x: int, multiple: int) -> int:
    """kernels.pad_to, re-stated (round up to a positive multiple)."""
    return max(multiple, ((x + multiple - 1) // multiple) * multiple)


def dispatch_pad_plan(enc) -> dict:
    """The padded geometry a one-history BatchShape.plan would pick for
    this encoding — the shape the v2 sidecar persists at."""
    return {"n_txns": _pad_up(enc.n, _PAD_TXNS),
            "n_appends": _pad_up(len(enc.appends), _PAD_MINOR),
            "n_reads": _pad_up(len(enc.reads), _PAD_MINOR),
            "n_keys": _pad_up(enc.n_keys, _PAD_MINOR),
            "max_pos": _pad_up(enc.max_pos, _PAD_MINOR)}


# Per-checker array fields of a lean encoding, in canonical layout
# order (the C++ sidecar writer mirrors it in hist_encode.cc's
# write_sidecar).
ENCODED_FIELDS = {
    "append": ("appends", "reads", "status", "process",
               "invoke_index", "complete_index"),
    "wr": ("edges", "status", "process", "invoke_index",
           "complete_index"),
}


def encoded_arrays(enc, checker: str) -> list:
    """[(field, contiguous ndarray)] for a lean encoding, in
    ENCODED_FIELDS order (WrEncoded.edges — a list of 3-tuples — is
    densified to int32 [E,3])."""
    import numpy as np
    out = []
    for f in ENCODED_FIELDS[checker]:
        v = getattr(enc, f)
        if f == "edges":
            v = np.asarray(v or np.zeros((0, 3)),
                           np.int32).reshape(-1, 3)
        out.append((f, np.ascontiguousarray(v)))
    return out


def rebuild_encoded(checker: str, arrays: dict, meta: dict):
    """(arrays + scalars) -> EncodedHistory/WrEncoded: the v1 sidecar
    loader's one reconstruction (op_index aliasing, edges re-tupled)."""
    if checker == "wr":
        from .checker.elle.wr import WrEncoded
        enc = WrEncoded()
        enc.n = int(meta["n"])
        enc.key_count = int(meta["key_count"])
        enc.edges = [tuple(r) for r in arrays["edges"].tolist()]
    else:
        from .checker.elle.encode import EncodedHistory
        enc = EncodedHistory()
        enc.n = int(meta["n"])
        enc.n_keys = int(meta["n_keys"])
        enc.max_pos = int(meta["max_pos"])
        enc.key_names = meta["key_names"]
        enc.appends = arrays["appends"]
        enc.reads = arrays["reads"]
        enc.op_index = arrays["complete_index"]
    enc.status = arrays["status"]
    enc.process = arrays["process"]
    enc.invoke_index = arrays["invoke_index"]
    enc.complete_index = arrays["complete_index"]
    enc.anomalies = meta["anomalies"]
    enc.txn_ops = []
    return enc


# Bounded content hash: first + last 64KiB (whole file when smaller).
# Histories are append-only artifacts — corruption or rewrite shows up
# at one end — and an unbounded hash would put a full file read back on
# the path the cache exists to remove.
_HASH_SPAN = 64 * 1024

_X1 = 0x9E3779B185EBCA87
_X2 = 0xC2B2AE3D27D4EB4F
_X3 = 0x165667B19E3779F9
_X4 = 0x85EBCA77C2B2AE63
_X5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """Pure-Python XXH64, bit-exact with the algorithm and with
    hist_encode.cc's jt_xxh64_buf: the parity oracle, and the hasher
    when the native library is off (JEPSEN_TPU_NO_NATIVE)."""
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _X1 + _X2) & _M64
        v2 = (seed + _X2) & _M64
        v3 = seed & _M64
        v4 = (seed - _X1) & _M64
        while i + 32 <= n:
            for off, v in ((0, v1), (8, v2), (16, v3), (24, v4)):
                lane = int.from_bytes(data[i + off:i + off + 8],
                                      "little")
                v = (_rotl((v + lane * _X2) & _M64, 31) * _X1) & _M64
                if off == 0:
                    v1 = v
                elif off == 8:
                    v2 = v
                elif off == 16:
                    v3 = v
                else:
                    v4 = v
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h ^= (_rotl((v * _X2) & _M64, 31) * _X1) & _M64
            h = (h * _X1 + _X4) & _M64
    else:
        h = (seed + _X5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        k = (int.from_bytes(data[i:i + 8], "little") * _X2) & _M64
        h ^= (_rotl(k, 31) * _X1) & _M64
        h = (_rotl(h, 27) * _X1 + _X4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _X1) & _M64
        h = (_rotl(h, 23) * _X2 + _X3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _X5) & _M64
        h = (_rotl(h, 11) * _X1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _X2) & _M64
    h ^= h >> 29
    h = (h * _X3) & _M64
    h ^= h >> 32
    return h


def _buf_xxh64(data: bytes) -> int:
    """XXH64 via the native library (one C call), pure Python under
    JEPSEN_TPU_NO_NATIVE — both bit-identical, so cache keys do not
    depend on which side hashed. A library that cannot be built
    raises, as everywhere in the port."""
    from .checker.elle import native_encode
    L = native_encode.hist_lib()
    if L is not None:
        return L.jt_xxh64_buf(data, len(data), 0)
    return xxh64(data)


def bounded_file_xxh64(path: Path, size: int) -> int:
    """xxh64 over the first + last _HASH_SPAN bytes (whole file when
    it fits in one window pair) — the content part of the cache key,
    byte-identical to the C++ side's file_cache_key()."""
    with open(path, "rb") as f:
        if size <= 2 * _HASH_SPAN:
            data = f.read()
        else:
            head = f.read(_HASH_SPAN)
            f.seek(size - _HASH_SPAN)
            data = head + f.read(_HASH_SPAN)
    return _buf_xxh64(data)


def encode_cache_enabled() -> bool:
    """The JEPSEN_TPU_ENCODE_CACHE master gate (default on)."""
    from . import gates
    return gates.get("JEPSEN_TPU_ENCODE_CACHE")


def encode_cache_write_enabled() -> bool:
    """JEPSEN_TPU_ENCODE_CACHE_WRITE=0 makes the cache read-only
    (e.g. sweeping a store on a read-only mount)."""
    from . import gates
    return gates.get("JEPSEN_TPU_ENCODE_CACHE_WRITE")


def sidecar_v2_enabled() -> bool:
    """The JEPSEN_TPU_SIDECAR_V2 gate (default on): append sidecars are
    written dispatch-shaped (encoded.v2.bin) and v1 sidecars upgrade in
    place on load. 0 pins the v1 format."""
    from . import gates
    return gates.get("JEPSEN_TPU_SIDECAR_V2")


def sidecar_version(checker: str) -> int:
    """The sidecar version the current env writes for `checker`: v2 is
    append-only (the wr edge packer has no padded fast path)."""
    return 2 if checker == "append" and sidecar_v2_enabled() else 1


def encoded_cache_path(run_dir: str | os.PathLike, checker: str,
                       version: int | None = None) -> Path:
    """The per-checker sidecar path: append and wr digests of the same
    history are different tensors, so they cache separately. `version`
    defaults to what the env would write (`sidecar_version`)."""
    if version is None:
        version = sidecar_version(checker)
    name = f"encoded.v{version}.bin" if checker == "append" \
        else f"encoded-{checker}.v1.bin"
    return Path(run_dir) / name


def _history_source(run_dir: Path) -> Path | None:
    """The file the cache key covers — the same preference order as
    load_history_dir, so the cache can never validate against a file
    the encode would not have read."""
    jl = run_dir / "history.jsonl"
    if jl.is_file():
        return jl
    ed = run_dir / "history.edn"
    return ed if ed.is_file() else None


def _cache_key(src: Path) -> dict:
    st = src.stat()
    return {"size": st.st_size, "mtime_ns": st.st_mtime_ns,
            "xxh64": f"{bounded_file_xxh64(src, st.st_size):016x}"}


def _align64(n: int) -> int:
    return (n + 63) & ~63


def _padded_arrays(enc, pad: dict) -> list:
    """[(field, contiguous ndarray)] for the v2 (dispatch-shaped)
    sidecar: the lean arrays padded to `pad` with pack_batch's fill
    convention (-1 dead triples/process rows, 0 dead index rows), plus
    the two dispatch tensors pack_batch would otherwise compute per
    sweep — int32 invoke keys and int32 EFFECTIVE completion keys."""
    import numpy as np

    from .checker.elle.encode import effective_complete_index
    T, A, R = pad["n_txns"], pad["n_appends"], pad["n_reads"]
    n = enc.n
    appends = np.full((A, 3), -1, np.int32)
    appends[:len(enc.appends)] = np.asarray(enc.appends,
                                            np.int32).reshape(-1, 3)
    reads = np.full((R, 3), -1, np.int32)
    reads[:len(enc.reads)] = np.asarray(enc.reads,
                                        np.int32).reshape(-1, 3)
    process = np.full(T, -1, np.int32)
    process[:n] = np.asarray(enc.process, np.int32)
    d_invoke = np.zeros(T, np.int32)
    d_invoke[:n] = np.asarray(enc.invoke_index, np.int32)
    d_complete = np.zeros(T, np.int32)
    d_complete[:n] = effective_complete_index(
        np.asarray(enc.status, np.int32),
        np.asarray(enc.complete_index, np.int64)).astype(np.int32)
    return [("appends", appends), ("reads", reads),
            ("status", np.ascontiguousarray(enc.status, np.int32)),
            ("process", process),
            ("invoke_index",
             np.ascontiguousarray(enc.invoke_index, np.int64)),
            ("complete_index",
             np.ascontiguousarray(enc.complete_index, np.int64)),
            ("d_invoke", d_invoke), ("d_complete", d_complete)]


def save_encoded(run_dir: str | os.PathLike, checker: str,
                 enc) -> Path | None:
    """Write the flat encoded sidecar for a LEAN encoding (v2 when
    `sidecar_version(checker)` says so, else v1). Best-effort: any
    failure (non-JSON-able keys, read-only dir) returns None and the
    run simply stays uncached. Layout — magic, int64 header length,
    JSON header, zero pad to 64, then each tensor raw at the
    64-aligned offset its header entry records (relative to the data
    start, itself align64(16 + header_len)). A successful v2 write
    also retires the run's v1 sidecar."""
    if not (encode_cache_enabled() and encode_cache_write_enabled()):
        return None
    d = Path(run_dir)
    src = _history_source(d)
    if src is None:
        return None
    version = sidecar_version(checker)
    tmp = None
    try:
        if version == 2:
            pad = dispatch_pad_plan(enc)
            arrays = _padded_arrays(enc, pad)
            meta = {"n": enc.n, "n_keys": enc.n_keys,
                    "max_pos": enc.max_pos,
                    "key_names": list(enc.key_names),
                    "pad": pad,
                    "lens": {"appends": len(enc.appends),
                             "reads": len(enc.reads)}}
            magic = ENCODED_MAGIC_V2
        else:
            arrays = encoded_arrays(enc, checker)
            if checker == "wr":
                meta = {"n": enc.n, "key_count": enc.key_count}
            else:
                meta = {"n": enc.n, "n_keys": enc.n_keys,
                        "max_pos": enc.max_pos,
                        "key_names": list(enc.key_names)}
            magic = ENCODED_MAGIC
        off = 0
        entries = {}
        for name, a in arrays:
            off = _align64(off)
            entries[name] = [off, list(a.shape), a.dtype.str]
            off += a.nbytes
        header = {"v": version, "checker": checker, "src": src.name,
                  "key": _cache_key(src), "arrays": entries,
                  "anomalies": enc.anomalies, **meta}
        hj = json.dumps(header).encode()
        data_start = _align64(len(magic) + 8 + len(hj))
        out = encoded_cache_path(d, checker, version)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            f.write(magic)
            f.write(len(hj).to_bytes(8, "little"))
            f.write(hj)
            f.write(b"\0" * (data_start - len(magic) - 8
                             - len(hj)))
            pos = 0
            for name, a in arrays:
                aligned = _align64(pos)
                f.write(b"\0" * (aligned - pos))
                f.write(memoryview(a).cast("B") if a.nbytes else b"")
                pos = aligned + a.nbytes
        os.replace(tmp, out)
        if version == 2:
            try:
                encoded_cache_path(d, checker, 1).unlink()
            except OSError:
                pass
        return out
    except Exception:
        log.debug("encoded-cache write failed for %s", d, exc_info=True)
        try:
            if tmp is not None:
                tmp.unlink(missing_ok=True)
        except Exception:
            pass
        return None


def load_encoded(run_dir: str | os.PathLike, checker: str):
    """mmap the encoded sidecar back into an EncodedHistory/WrEncoded
    (zero-copy views over the mapped pages), or None on a miss: no
    sidecar, stale key (history changed), wrong checker, or any parse
    failure. Prefers the dispatch-shaped v2 sidecar when the gate is
    on (the encoding then carries `.dispatch`, pre-padded views the
    batch packer stacks as they are, and `.dispatch_pad`, the geometry
    they were padded to); a v1-only run upgrades to v2 in place on the
    way through. Every cache-loaded encoding is flagged `.warm = True`
    so the pack stage can attribute `warm_copy_bytes`."""
    if not encode_cache_enabled():
        return None
    d = Path(run_dir)
    src = _history_source(d)
    if src is None:
        return None
    want_v2 = sidecar_version(checker) == 2
    if want_v2:
        enc = _load_sidecar(encoded_cache_path(d, checker, 2), 2,
                            checker, src)
        if enc is not None:
            return enc
    enc = _load_sidecar(encoded_cache_path(d, checker, 1), 1,
                        checker, src)
    if enc is None:
        return None
    if want_v2 and encode_cache_write_enabled():
        enc = _upgrade_sidecar(d, checker, enc)
    return enc


def _upgrade_sidecar(run_dir: Path, checker: str, enc):
    """v1 → v2 in place: rewrite the sidecar dispatch-shaped and serve
    the v2 views. A failed write (read-only mount) keeps serving the
    v1 encoding — the upgrade is an optimization, never a gate."""
    out = save_encoded(run_dir, checker, enc)
    if out is None:
        return enc
    from . import trace
    trace.counter("sidecar_upgrades").inc()
    from .obs import events as obs_events
    obs_events.emit("cache_rebuild", path=str(out),
                    cause="v1->v2 upgrade")
    src = _history_source(Path(run_dir))
    enc2 = _load_sidecar(out, 2, checker, src) if src is not None \
        else None
    if enc2 is not None:
        enc2.upgraded = True
        return enc2
    return enc


def _map_retrying(p: Path):
    """A read-only mmap of `p`. Transient open/mmap failures
    (EMFILE/ENOMEM under a big sweep's pressure) get two jittered,
    exponentially backed-off retries before the cache degrades to a
    miss; a vanished sidecar fails straight to the re-encode."""
    import mmap as _mmap
    import random
    import time
    for attempt in range(3):
        try:
            with open(p, "rb") as f:
                return _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except FileNotFoundError:
            raise
        except OSError:
            if attempt == 2:
                raise
            time.sleep(0.005 * 2 ** attempt * random.uniform(0.5, 1.5))


def _load_sidecar(p: Path, version: int, checker: str, src: Path):
    """One sidecar file → encoding, or None on miss/corruption.
    Handles both writer dialects at either version — the Python writer
    embeds lean anomalies as JSON; the native writer stores raw
    anomaly rows + the pre-key name table, decoded here with the exact
    `_witness` mapping the in-process native path uses."""
    if not p.is_file():
        return None
    magic = ENCODED_MAGIC_V2 if version == 2 else ENCODED_MAGIC
    try:
        import numpy as np

        mm = _map_retrying(p)
        if mm[:len(magic)] != magic:
            # an existing sidecar without the magic is corruption, not
            # a miss — the flight recorder gets the rebuild cause
            from .obs import events as obs_events
            obs_events.emit("cache_rebuild", path=str(p),
                            cause="bad magic")
            return None
        hlen = int.from_bytes(
            mm[len(magic):len(magic) + 8], "little")
        header = json.loads(
            mm[len(magic) + 8:len(magic) + 8 + hlen])
        if header.get("v") != version \
                or header.get("checker") != checker \
                or header.get("src") != src.name:
            return None
        if header.get("key") != _cache_key(src):
            return None
        data_start = _align64(len(magic) + 8 + hlen)
        arrays = {}
        for name, (off, shape, dt) in header["arrays"].items():
            n = 1
            for s in shape:
                n *= s
            arrays[name] = np.frombuffer(
                mm, dtype=np.dtype(dt), count=n,
                offset=data_start + off).reshape(shape)
        pre_names = header.get("pre_names", [])
        if "anomalies" in header:
            anomalies = header["anomalies"]
        else:
            # native-written sidecar: raw anomaly rows, decoded with
            # the exact _witness mapping the in-process native path
            # uses, so cache-loaded == freshly-encoded
            from .checker.elle.native_encode import _CODES, _witness
            anomalies = {}
            for code, f0, f1, f2, f3 in arrays.pop("anom").tolist():
                name = _CODES.get(int(code))
                if name is None:    # ABI drift: don't guess
                    return None
                anomalies.setdefault(name, []).append(
                    _witness(int(code), int(f0), int(f1), int(f2),
                             int(f3), pre_names, wr=checker == "wr"))
        meta = {k: header[k] for k in ("n", "n_keys", "max_pos",
                                       "key_count") if k in header}
        meta["anomalies"] = anomalies
        if checker != "wr":
            meta["key_names"] = header["key_names"] \
                if "key_names" in header else \
                [pre_names[i] for i in arrays.pop("kid_to_pre").tolist()]
        if version == 2:
            enc = _rebuild_v2(arrays, meta, header)
        else:
            enc = rebuild_encoded(checker, arrays, meta)
        enc.warm = True
        return enc
    except Exception as e:
        log.debug("encoded-cache load failed for %s", p, exc_info=True)
        from .obs import events as obs_events
        obs_events.emit("cache_rebuild", path=str(p),
                        cause=repr(e)[:200])
        return None


def _rebuild_v2(arrays: dict, meta: dict, header: dict):
    """(padded mmap arrays + scalars) → EncodedHistory whose lean
    fields are SLICES of the padded tensors and whose `.dispatch` dict
    holds the full dispatch-shaped views (pack order: appends, reads,
    invoke, complete (effective), process)."""
    from .checker.elle.encode import EncodedHistory
    n = int(meta["n"])
    lens = header["lens"]
    pad = header["pad"]
    enc = EncodedHistory()
    enc.n = n
    enc.n_keys = int(meta["n_keys"])
    enc.max_pos = int(meta["max_pos"])
    enc.key_names = meta["key_names"]
    enc.appends = arrays["appends"][:int(lens["appends"])]
    enc.reads = arrays["reads"][:int(lens["reads"])]
    enc.status = arrays["status"]
    enc.process = arrays["process"][:n]
    enc.invoke_index = arrays["invoke_index"]
    enc.complete_index = arrays["complete_index"]
    enc.op_index = arrays["complete_index"]
    enc.anomalies = meta["anomalies"]
    enc.txn_ops = []
    enc.dispatch = {"appends": arrays["appends"],
                    "reads": arrays["reads"],
                    "invoke_index": arrays["d_invoke"],
                    "complete_index": arrays["d_complete"],
                    "process": arrays["process"]}
    enc.dispatch_pad = {k: int(v) for k, v in pad.items()}
    return enc


def _results_to_edn(v: Any) -> Any:
    """Convert a results dict (string keys) to EDN with keyword keys."""
    if isinstance(v, dict):
        return {edn.Keyword(str(k)) if isinstance(k, str) else k:
                _results_to_edn(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_results_to_edn(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, (int, float)):
        return v
    if isinstance(v, (set, frozenset)):
        return frozenset(_results_to_edn(x) for x in v)
    if isinstance(v, str):
        return edn.Keyword(v) if v in ("unknown", "valid", "invalid") else v
    return repr(v)

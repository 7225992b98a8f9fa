"""The on-disk store of test runs: the part of `jepsen_tpu/store.py` the
batch sweep reads and writes.

Layout (the reference's `store/<test-name>/<start-time>/`):

    store/<test-name>/<start-time>/
        history.jsonl   one op per line (preferred)
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

log = logging.getLogger(__name__)

# Keys of a test map that never serialize (functions, live
# connections...).
NONSERIALIZABLE_KEYS = (
    "db", "os", "net", "client", "checker", "nemesis", "generator", "model",
    "remote", "store", "logging", "barrier", "sessions", "args",
)

DEFAULT_BASE = "store"


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

    def save_2(self, test: dict) -> dict:
        """Persist results (after analysis): test.json, results.json and
        .edn, and the links. The reference's `write_trace` is left out:
        under the sweep-scoped tracer of an analyze-store sweep, the
        only caller here, it writes nothing."""
        self.write_test(test)
        self.write_results(test)
        self.update_symlinks(test)
        return test

    # -- reads ------------------------------------------------------------

    def iter_run_dirs(self, name: str | None = None):
        """Run dirs `<base>/<name>/<run>` in sorted order, one
        `os.scandir` per directory; with `name`, only that test name's
        runs. The `latest`/`current` links are skipped by name, as the
        reference's walk does."""
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
                yield base / nm / rn

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

    def record(self, run_dir, checker: str, res: dict) -> bool:
        """Append one verdict line; True when it landed."""
        entry = {"dir": self.rel(run_dir), "checker": checker,
                 "valid?": res.get("valid?")}
        for k in ("quarantined", "error"):
            if k in res:
                entry[k] = res[k]
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


#: The analytics ledger's file name (`JEPSEN_TPU_KERNEL_STATS`).
ANALYTICS_NAME = "analytics.jsonl"


def analytics_path(store_base, shard: int | None = None) -> Path:
    """The analytics ledger of a store (`analytics-shard<k>.jsonl` for a
    shard of a multi-host sweep, as the reference names it)."""
    if shard is None:
        return Path(store_base) / ANALYTICS_NAME
    return Path(store_base) / f"analytics-shard{shard}.jsonl"


def append_analytics(path, records: list[dict]) -> int:
    """Append stats records as JSON lines, each flushed as written; a
    crash-torn tail from a previous writer is sealed first (the
    journal's rule). Best-effort: a read-only store returns 0, never
    raises."""
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
        log.debug("analytics append failed for %s", p, exc_info=True)
    return n


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

"""The on-disk store of test runs: the part of `jepsen_tpu/store.py` the
batch sweep reads and writes.

Layout (the reference's `store/<test-name>/<start-time>/`):

    store/<test-name>/<start-time>/
        history.jsonl   one op per line (preferred)
        history.edn     the same ops as EDN (fallback)
        results.json    verdict written by analyze-store
        results.edn     the same verdict as EDN
        .sweep-<checker>  resume marker with the verdict's validity
    store/verdicts.jsonl  one line per verdict, appended as it lands
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any

from . import edn
from . import history as h

log = logging.getLogger(__name__)

DEFAULT_BASE = "store"


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

    def iter_run_dirs(self):
        """Run dirs `<base>/<name>/<run>` in sorted order, one
        `os.scandir` per directory. The `latest`/`current` links are
        skipped by name, as the reference's walk does."""
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
            try:
                with os.scandir(base / nm) as it:
                    runs = sorted(
                        e.name for e in it
                        if e.name != "latest" and e.is_dir())
            except OSError:
                continue
            for rn in runs:
                yield base / nm / rn


class VerdictJournal:
    """Append-only per-history verdict log (`verdicts.jsonl`), one
    flushed line per verdict: {"dir" (relative to the store), "checker",
    "valid?"}, plus "quarantined" and "error" for a quarantined run. Writes are best-effort: a read-only store must not sink
    the sweep."""

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
                        if rf.read(1) != b"\n":
                            self._f.write("\n")
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

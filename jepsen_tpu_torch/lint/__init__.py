"""jepsen_tpu_torch.lint — the port's self-hosted static-analysis pass.

The port's copy of the reference's linter (`jepsen_tpu/lint/`), with
its rule ids unchanged and every path it names moved to the port: the
package it scans (`jepsen_tpu_torch/`), the contracts' modules, the
gate registry (`jepsen_tpu_torch.gates`), the metric registry
(`jepsen_tpu_torch.trace`), the C ABI (`csrc/` against
`_build.PROTOTYPES`), the baseline (`lint_baseline_torch.json`) and the
generated README tables (between markers that name this package). The
package's core invariants — gates declared once, spawn-only process
pools, lexically-paired shm unlink, spans as context managers, metric
names from the declared registry, the store artifacts' durability
protocols, the serve protocol's orderings, the C ABI — are checked on
every commit instead of by review and by runtime failure.

Architecture:

  * `Finding` — one violation: rule id, file:line, message, fix hint;
    machine-readable via `--format json` for CI.
  * module rules (`ModuleRule`) — pure-AST passes over each file of
    the package, grouped in rule families: JT-GATE (env-gate
    registry), JT-JAX (host-sync/recompile hazards; it finds nothing
    in a torch package and is kept so the family's contract stays
    whole), JT-THREAD (concurrency discipline), JT-SHM (shared-memory
    lifecycle), JT-TRACE (tracer/span + metric-name discipline),
    JT-DUR (store-artifact durability protocols over the fileflow
    pass).
  * project rules (`ProjectRule`) — whole-repo checks that need more
    than one file: the README tables must match their renders; every
    registered gate must appear in the port's tests; the ABI prover.
  * suppressions — inline `# jt-lint: ok JT-XXX-000 (reason)` on the
    offending line (or alone on the line above) for sanctioned
    sites, and a repo-level `lint_baseline_torch.json` of justified
    `{rule, path, max, reason}` entries for grandfathered debt. A
    baseline entry that no longer matches anything is reported as
    stale so suppressions can only shrink.

`tests/test_torch_lint.py` runs it over `jepsen_tpu_torch/` at every
commit, and `python -m jepsen_tpu_torch.cli lint` / `python -m
jepsen_tpu_torch.lint` expose the same pass with the standard exit
codes (0 clean, 1 findings, 254 usage); `--tables` regenerates the
README's generated blocks. Stdlib-only: `ast` + `re`, no third-party
dependencies, and target files are parsed, never imported or executed.
"""

from __future__ import annotations

import ast
import json
import os
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

__all__ = [
    "Finding", "ModuleCtx", "ModuleRule", "ProjectRule", "ProjectCtx",
    "all_rules", "rule_ids", "rule_table", "render_rule_block",
    "lint_paths", "lint_project", "apply_baseline", "load_baseline",
    "LintCache", "changed_files", "family_of", "main",
]


def family_of(rule_id: str) -> str:
    """'JT-GATE' for 'JT-GATE-001' — the per-family rollup key.
    Ids without a numeric suffix (the JT-PARSE sentinel) are their own
    family."""
    head, _, tail = rule_id.rpartition("-")
    return head if head and tail.isdigit() else rule_id


def findings_by_family(findings: list["Finding"]) -> dict[str, int]:
    """Open findings rolled up per family, every registered family
    present (zero-seeded) — the rollup `lint --format json` emits."""
    fams = {family_of(i): 0 for i in rule_ids()}
    for f in findings:
        fams[family_of(f.rule)] = fams.get(family_of(f.rule), 0) + 1
    return dict(sorted(fams.items()))


@dataclass(frozen=True)
class Finding:
    """One violation: where, which rule, what, and how to fix it."""

    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    hint: str = ""

    def render(self) -> str:
        h = f"  [fix: {self.hint}]" if self.hint else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{h}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint}


# ---------------------------------------------------------------------------
# Per-module context: one parse, shared by every rule.
# ---------------------------------------------------------------------------

#: `# jt-lint: ok JT-GATE-001 (why)` — rule ids may be comma-separated;
#: a family prefix (`JT-GATE`) suppresses the whole family on that line.
_SUPPRESS_RE = re.compile(
    r"#\s*jt-lint:\s*ok\s+([A-Z][A-Z0-9-]*(?:\s*,\s*[A-Z][A-Z0-9-]*)*)")


class ModuleCtx:
    """One target file: source, AST, per-line suppressions."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source, filename=rel)
        self.lines = source.splitlines()
        # line number -> set of suppressed rule-id/family strings
        self.suppressions: dict[int, set[str]] = {}
        for i, ln in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(ln)
            if not m:
                continue
            ids = {s.strip() for s in m.group(1).split(",")}
            self.suppressions.setdefault(i, set()).update(ids)
            # a comment-only line suppresses the line below it too
            if ln.lstrip().startswith("#"):
                self.suppressions.setdefault(i + 1, set()).update(ids)

    def suppressed(self, f: Finding) -> bool:
        ids = self.suppressions.get(f.line)
        if not ids:
            return False
        return any(f.rule == s or f.rule.startswith(s + "-") for s in ids)


class ProjectCtx:
    """Whole-repo context for project rules: the repo root plus the
    already-parsed package modules."""

    def __init__(self, root: Path, modules: list[ModuleCtx]):
        self.root = root
        self.modules = modules
        self._by_rel: dict[str, ModuleCtx | None] | None = None

    def module(self, rel: str) -> ModuleCtx | None:
        """The parsed ModuleCtx for a repo-relative path — ONE parse
        per file per run, shared by every rule family (rules_abi and
        wireflow used to each re-parse their targets). Falls back to
        a disk parse when the path wasn't in the module-rule walk
        (`--changed` mode's empty-modules ProjectCtx, fixture trees);
        missing or unparseable files degrade to None, never raise."""
        if self._by_rel is None:
            self._by_rel = {m.rel: m for m in self.modules}
        if rel not in self._by_rel:
            p = self.root / rel
            m: ModuleCtx | None = None
            if p.is_file():
                try:
                    m = _load_ctx(p, self.root)
                except LintParseError:
                    m = None
            self._by_rel[rel] = m
        return self._by_rel[rel]


class ModuleRule:
    """A per-file AST pass. Subclasses set `id`/`hint` and implement
    `check(ctx)` yielding Findings."""

    id: str = ""
    hint: str = ""
    doc: str = ""

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleCtx, node: ast.AST | int,
                message: str) -> Finding:
        line = node if isinstance(node, int) \
            else getattr(node, "lineno", 1)
        return Finding(self.id, ctx.rel, line, message, self.hint)


class ProjectRule:
    """A whole-repo pass (README drift, test coverage)."""

    id: str = ""
    hint: str = ""
    doc: str = ""

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# AST helpers shared by the rule modules.
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> str | None:
    """`a.b.c` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def call_name(node: ast.Call) -> str | None:
    """Dotted name of a call's callee, if it is a plain name chain."""
    return dotted(node.func)


def walk_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node  # type: ignore[misc]


# ---------------------------------------------------------------------------
# Rule registry.
# ---------------------------------------------------------------------------

def all_rules() -> tuple[list[ModuleRule], list[ProjectRule]]:
    """Every registered rule instance (module rules, project rules)."""
    from . import (order, rules_abi, rules_concurrency, rules_dur,
                   rules_gates, rules_jax, rules_lock, rules_meta,
                   rules_shm, rules_tensor, rules_trace, wireflow)
    mod: list[ModuleRule] = []
    proj: list[ProjectRule] = []
    for m in (rules_gates, rules_jax, rules_concurrency, rules_shm,
              rules_trace, rules_abi, rules_tensor, rules_lock,
              rules_dur, order, wireflow, rules_meta):
        for r in m.RULES:
            (proj if isinstance(r, ProjectRule) else mod).append(r)
    return mod, proj


def rule_ids() -> list[str]:
    mod, proj = all_rules()
    return sorted(r.id for r in mod + proj)


def rule_table() -> list[dict]:
    """id/doc/hint rows for the README rule-id table and --list-rules."""
    mod, proj = all_rules()
    return [{"id": r.id, "doc": r.doc, "hint": r.hint}
            for r in sorted(mod + proj, key=lambda r: r.id)]


#: README markers for the port's generated rule table (the env-gate
#: table's pattern: edit the rules, run `python -m jepsen_tpu_torch.lint
#: --tables`, JT-META-001 fails the build on drift). They name this
#: package, so they differ from the reference's block beside them.
RULES_BEGIN = "<!-- lint-rules:begin (generated by jepsen_tpu_torch.lint) -->"
RULES_END = "<!-- lint-rules:end (jepsen_tpu_torch.lint) -->"


def render_rule_table() -> str:
    rows = ["| rule | checks |", "|---|---|"]
    for r in rule_table():
        rows.append(f"| {r['id']} | {' '.join(r['doc'].split())} |")
    return "\n".join(rows)


def render_rule_block() -> str:
    return f"{RULES_BEGIN}\n{render_rule_table()}\n{RULES_END}"


# ---------------------------------------------------------------------------
# Runners.
# ---------------------------------------------------------------------------

#: Files exempt from everything: generated/vendored trees would go
#: here. (The package has none today.)
_SKIP_PARTS = {"__pycache__"}


#: The port's baseline file, at the repo root (the reference's
#: `lint_baseline.json` is neither read nor written here).
BASELINE_FILE = "lint_baseline_torch.json"


def write_tables(root: Path) -> list[str]:
    """Rewrite the port's four generated README blocks (rule table,
    env-gate table, store-durability table, wire-frame table) in
    place, each between its markers; returns the names rewritten. A
    README without a block's markers raises ValueError."""
    from .. import gates
    from . import contracts, wireflow
    root = Path(root)
    readme = root / "README.md"
    text = readme.read_text(encoding="utf-8")
    blocks = (
        ("rule table", RULES_BEGIN, RULES_END, render_rule_block()),
        ("env-gate table", gates.TABLE_BEGIN, gates.TABLE_END,
         gates.render_env_block()),
        ("store-durability table", contracts.DUR_BEGIN,
         contracts.DUR_END, contracts.render_dur_block()),
        ("wire-frame table", wireflow.WIRE_BEGIN, wireflow.WIRE_END,
         wireflow.render_wire_block(wireflow.live_registry(root))),
    )
    done = []
    for name, begin, end, block in blocks:
        if begin not in text or end not in text:
            raise ValueError(f"README.md lacks the {name} markers "
                             f"({begin!r})")
        s = text.index(begin)
        e = text.index(end) + len(end)
        text = text[:s] + block + text[e:]
        done.append(name)
    readme.write_text(text, encoding="utf-8")
    return done


def iter_py_files(base: Path) -> Iterator[Path]:
    for p in sorted(base.rglob("*.py")):
        if not _SKIP_PARTS.intersection(p.parts):
            yield p


def _load_ctx(path: Path, root: Path) -> ModuleCtx | None:
    try:
        src = path.read_text(encoding="utf-8")
        rel = path.resolve().relative_to(root.resolve()).as_posix() \
            if path.resolve().is_relative_to(root.resolve()) \
            else path.as_posix()
        return ModuleCtx(path, rel, src)
    except (OSError, SyntaxError, ValueError) as e:
        # a file the linter cannot parse is itself a finding, surfaced
        # by the caller via the sentinel
        raise LintParseError(path, e) from e


class LintParseError(Exception):
    def __init__(self, path: Path, err: Exception):
        super().__init__(f"{path}: {err}")
        self.path = path
        self.err = err


def lint_paths(paths: Iterable[Path], root: Path,
               rules: list[ModuleRule] | None = None,
               cache: "LintCache | None" = None) -> list[Finding]:
    """Run the module rules over explicit files (fixture tests use
    this); inline suppressions apply, the baseline does not. With a
    `cache`, per-file results are keyed by content hash + engine
    fingerprint — a clean re-run of an unchanged file costs one hash."""
    if rules is None:
        rules, _ = all_rules()
    out: list[Finding] = []
    for p in paths:
        p = Path(p)
        if cache is not None:
            cached = cache.get(p)
            if cached is not None:
                out.extend(cached)
                continue
        try:
            ctx = _load_ctx(p, root)
        except LintParseError as e:
            out.append(Finding("JT-PARSE", str(e.path), 1,
                               f"unparseable: {e.err}",
                               "fix the syntax error"))
            continue
        found = [f for r in rules for f in r.check(ctx)
                 if not ctx.suppressed(f)]
        if cache is not None:
            cache.put(p, found)
        out.extend(found)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def lint_project(root: Path, package_dir: Path | None = None,
                 cache: "LintCache | None" = None) -> list[Finding]:
    """The full pass: module rules over every file of the package,
    then the project rules (README drift, gate test coverage, the ABI
    prover). Baseline NOT yet applied — see `apply_baseline`. With a
    `cache`, unchanged files are served from the content-hash store
    (sound: module-rule findings are a pure function of file bytes +
    the engine fingerprint); project rules always run fresh."""
    root = Path(root)
    if package_dir is None:
        package_dir = root / "jepsen_tpu_torch"
    mod_rules, proj_rules = all_rules()
    findings: list[Finding] = []
    modules: list[ModuleCtx] = []
    for p in iter_py_files(package_dir):
        try:
            ctx = _load_ctx(p, root)
        except LintParseError as e:
            findings.append(Finding("JT-PARSE", str(e.path), 1,
                                    f"unparseable: {e.err}",
                                    "fix the syntax error"))
            continue
        # the ctx is built even on a cache hit (parsing is the cheap
        # part): ProjectCtx.modules must stay COMPLETE — a project
        # rule iterating it on a warm cache would otherwise silently
        # see only the dirty files
        modules.append(ctx)
        cached = cache.get(p) if cache is not None else None
        if cached is not None:
            findings.extend(cached)
            continue
        found = [f for r in mod_rules for f in r.check(ctx)
                 if not ctx.suppressed(f)]
        if cache is not None:
            cache.put(p, found)
        findings.extend(found)
    pctx = ProjectCtx(root, modules)
    for r in proj_rules:
        findings.extend(r.check_project(pctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------------
# Incremental mode: --changed + the content-hash result cache.
# ---------------------------------------------------------------------------

#: Out-of-package inputs module rules consult at check time: the gate
#: registry (JT-GATE-002), the declared metric names (JT-TRACE-002),
#: the typed event kinds (JT-TRACE-003). Editing any of these must
#: invalidate the cache exactly like editing a rule would.
_RULE_INPUT_SOURCES = ("gates.py", "trace.py", "obs/events.py")


def _engine_fingerprint() -> str:
    """Hash of everything that determines a file's findings besides
    the file itself: the lint engine's own sources plus the registry
    modules the rules consult (`_RULE_INPUT_SOURCES`). The cache can
    never serve findings from an older rule set or registry."""
    import hashlib
    h = hashlib.sha256()
    lint_dir = Path(__file__).resolve().parent
    for p in sorted(lint_dir.glob("*.py")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for rel in _RULE_INPUT_SOURCES:
        p = lint_dir.parent / rel
        h.update(rel.encode())
        try:
            h.update(p.read_bytes())
        except OSError:
            h.update(b"<absent>")
    return h.hexdigest()[:16]


class LintCache:
    """Per-file module-rule results under
    `bench_artifacts/.lintcache-torch/`, keyed by sha256(engine fingerprint
    + root-relative path + file bytes). The path is part of the key
    because findings are NOT a pure function of content: path-scoped
    rules (hot-path files, kernel modules, the gates-file exemption)
    fire differently for byte-identical files at different locations,
    and the findings themselves embed the path. Best-effort on every
    other axis: an unreadable or corrupt entry is a miss, a failed
    write is ignored — the cache can only make a run faster, never
    wrong."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "bench_artifacts" / ".lintcache-torch"
        self._fp = _engine_fingerprint()
        # get() then put() on a miss must not hash the file twice:
        # the key is memoized per path for this run's lifetime
        self._keys: dict[str, str | None] = {}
        self.hits = 0
        self.misses = 0

    def _key(self, path: Path) -> str | None:
        import hashlib
        memo = str(path)
        if memo in self._keys:
            return self._keys[memo]
        try:
            rel = path.resolve().relative_to(
                self.root.resolve()).as_posix() \
                if path.resolve().is_relative_to(self.root.resolve()) \
                else path.as_posix()
            h = hashlib.sha256(self._fp.encode())
            h.update(rel.encode())
            h.update(b"\0")
            h.update(path.read_bytes())
            key = h.hexdigest()
        except OSError:
            key = None
        self._keys[memo] = key
        return key

    def get(self, path: Path) -> list[Finding] | None:
        key = self._key(path)
        if key is None:
            return None
        try:
            data = json.loads((self.dir / f"{key}.json").read_text())
            out = [Finding(**f) for f in data]
        except (OSError, TypeError, ValueError):
            self.misses += 1
            return None
        self.hits += 1
        return out

    def put(self, path: Path, findings: list[Finding]) -> None:
        key = self._key(path)
        if key is None:
            return
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            tmp = self.dir / f".{key}.{os.getpid()}.tmp"
            tmp.write_text(json.dumps([f.as_dict() for f in findings]))
            os.replace(tmp, self.dir / f"{key}.json")
        except OSError:
            pass


def changed_files(root: Path) -> list[Path] | None:
    """Package .py files dirty vs the merge-base with the upstream
    branch (falling back to origin/main, main, then plain HEAD for a
    detached checkout), plus untracked files. None when git itself is
    unavailable — callers degrade to the full run."""
    import subprocess

    def git(*args: str):
        try:
            return subprocess.run(
                ["git", "-C", str(root), *args],
                capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            return None

    base = "HEAD"
    for ref in ("@{upstream}", "origin/main", "main"):
        r = git("merge-base", "HEAD", ref)
        if r is None:
            return None
        if r.returncode == 0:
            base = r.stdout.strip()
            break
    r = git("diff", "--name-only", base)
    if r is None or r.returncode != 0:
        return None
    names = set(r.stdout.split())
    r = git("ls-files", "--others", "--exclude-standard")
    if r is not None and r.returncode == 0:
        names.update(r.stdout.split())
    out = []
    for n in sorted(names):
        p = Path(root) / n
        if n.endswith(".py") and n.startswith("jepsen_tpu_torch/") \
                and p.is_file() \
                and not _SKIP_PARTS.intersection(p.parts):
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# Baseline.
# ---------------------------------------------------------------------------

@dataclass
class BaselineResult:
    kept: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    stale: list[dict] = field(default_factory=list)


def load_baseline(path: Path) -> list[dict]:
    """`lint_baseline_torch.json` entries: {rule, path, max, reason}. Every
    entry MUST carry a non-empty reason — an unjustified suppression
    is rejected (that's the point of the file)."""
    try:
        data = json.loads(Path(path).read_text())
    except FileNotFoundError:
        return []
    entries = data.get("entries", []) if isinstance(data, dict) else data
    out = []
    for e in entries:
        if not isinstance(e, dict) or not e.get("rule") \
                or not e.get("path") or not str(e.get("reason", "")).strip():
            raise ValueError(
                f"baseline entry needs rule/path/reason: {e!r}")
        out.append({"rule": e["rule"], "path": e["path"],
                    "max": int(e.get("max", 1)),
                    "reason": str(e["reason"])})
    return out


def apply_baseline(findings: list[Finding],
                   entries: list[dict]) -> BaselineResult:
    """Suppress up to `max` findings per (rule, path) entry; entries
    that match nothing are reported stale (suppressions must shrink,
    not accrete)."""
    res = BaselineResult()
    budget: dict[tuple[str, str], int] = {}
    for e in entries:
        budget[(e["rule"], e["path"])] = \
            budget.get((e["rule"], e["path"]), 0) + e["max"]
    used: dict[tuple[str, str], int] = {}
    for f in findings:
        key = (f.rule, f.path)
        if used.get(key, 0) < budget.get(key, 0):
            used[key] = used.get(key, 0) + 1
            res.suppressed.append(f)
        else:
            res.kept.append(f)
    for e in entries:
        if used.get((e["rule"], e["path"]), 0) == 0:
            res.stale.append(e)
    return res


# ---------------------------------------------------------------------------
# CLI entry (`python -m jepsen_tpu_torch.cli lint` and `python -m
# jepsen_tpu_torch.lint` both land here).
# ---------------------------------------------------------------------------

def default_root() -> Path:
    """The repo root: the directory holding the `jepsen_tpu_torch` package."""
    return Path(__file__).resolve().parents[2]


def run(paths: list[str] | None = None, *, root: Path | None = None,
        baseline: str | None = None, fmt: str = "text",
        changed: bool = False, out=None) -> int:
    """The lint run behind the CLI. Returns the exit code (0 clean,
    1 findings). `paths`: explicit files/dirs to lint with the module
    rules only; default is the full project pass (module + project
    rules + baseline). `changed` analyzes only files dirty vs the git
    merge-base through the content-hash result cache — the fast inner
    loop; the full run stays the tier-1 default."""
    out = out if out is not None else sys.stdout
    root = Path(root) if root is not None else default_root()
    cache_line = ""
    if paths:
        files: list[Path] = []
        for p in paths:
            pp = Path(p)
            files.extend(iter_py_files(pp) if pp.is_dir() else [pp])
        findings = lint_paths(files, root)
        res = BaselineResult(kept=findings)
        entries: list[dict] = []
    else:
        if changed:
            dirty = changed_files(root)
            if dirty is None:
                print("lint: --changed needs git; running the full "
                      "pass", file=sys.stderr)
                findings = lint_project(root)
            else:
                cache = LintCache(root)
                findings = lint_paths(dirty, root, cache=cache)
                mod_rules, proj_rules = all_rules()
                pctx = ProjectCtx(root, [])
                for r in proj_rules:
                    findings.extend(r.check_project(pctx))
                findings.sort(key=lambda f: (f.path, f.line, f.rule))
                cache_line = (f"lint: --changed: {len(dirty)} dirty "
                              f"file(s), cache {cache.hits} hit(s)")
        else:
            findings = lint_project(root, cache=LintCache(root))
        bpath = Path(baseline) if baseline \
            else root / BASELINE_FILE
        try:
            entries = load_baseline(bpath)
        except ValueError as e:
            print(f"lint: bad baseline: {e}", file=sys.stderr)
            return 254
        res = apply_baseline(findings, entries)
        if changed:
            # a partial view cannot judge staleness: an entry whose
            # file simply wasn't dirty would be reported dead
            res.stale = []

    if fmt == "json":
        print(json.dumps({
            "findings": [f.as_dict() for f in res.kept],
            "findings_by_family": findings_by_family(res.kept),
            "suppressed": len(res.suppressed),
            "baseline_entries": len(entries),
            "baseline_stale": res.stale,
            "rules": len(rule_ids()),
        }, indent=2), file=out)
    else:
        for f in res.kept:
            print(f.render(), file=out)
        for e in res.stale:
            print(f"lint: stale baseline entry (matched nothing): "
                  f"{e['rule']} {e['path']} — remove it", file=out)
        if cache_line:
            print(cache_line, file=out)
        n = len(res.kept)
        print(f"lint: {n} finding{'s' if n != 1 else ''} "
              f"({len(res.suppressed)} baseline-suppressed, "
              f"{len(rule_ids())} rules)", file=out)
    # stale baseline entries are findings too: the exit code is what
    # makes "the baseline can only shrink" enforceable from one command
    return 1 if res.kept or res.stale else 0


def add_args(p) -> None:
    """The lint CLI surface, defined ONCE — both entry points
    (`python -m jepsen_tpu_torch.lint` and the `lint` subcommand of
    `python -m jepsen_tpu_torch.cli`) build their parser from here, so the
    two documented commands cannot drift apart."""
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint with the module rules only "
                        "(default: the whole package + project rules + "
                        "baseline)")
    p.add_argument("--format", choices=("text", "json"),
                   default="text", dest="lint_format")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default "
                        "lint_baseline_torch.json at the repo root)")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detected)")
    p.add_argument("--changed", action="store_true",
                   help="analyze only files dirty vs the git "
                        "merge-base, through the content-hash result "
                        "cache (bench_artifacts/.lintcache-torch); project "
                        "rules still run in full")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("--tables", action="store_true",
                   help="rewrite the port's generated README blocks "
                        "(rules, env gates, store durability, wire "
                        "frames) and exit")


def run_from_args(args) -> int:
    """Dispatch a namespace produced by an `add_args` parser."""
    if getattr(args, "tables", False):
        root = Path(args.root) if args.root else default_root()
        try:
            done = write_tables(root)
        except (OSError, ValueError) as e:
            print(f"lint: {e}", file=sys.stderr)
            return 254
        print("README.md regenerated: " + ", ".join(done))
        return 0
    if args.list_rules:
        if args.lint_format == "json":
            print(json.dumps(rule_table(), indent=2))
        else:
            for r in rule_table():
                print(f"{r['id']}: {r['doc']}")
        return 0
    return run(args.paths or None, root=args.root,
               baseline=args.baseline, fmt=args.lint_format,
               changed=getattr(args, "changed", False))


def main(argv: list[str] | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.lint",
        description="the port's static analysis (gate registry, tensor "
                    "contracts, concurrency, shm lifecycle, tracer "
                    "discipline, durability, the serve protocol, the C "
                    "ABI)")
    add_args(p)
    try:
        args = p.parse_args(argv)
    except SystemExit as e:
        return 254 if e.code not in (0, None) else 0
    return run_from_args(args)

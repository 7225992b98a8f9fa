"""JT-DUR — store-artifact durability: every on-disk format a sweep
persists must speak its declared crash-consistency protocol.

Jepsen's history is only ground truth if it survives the faults the
harness injects (PAPER.md): the store has accumulated ~10
durability-critical store formats, each hand-implementing one of two
protocols — the flushed append-journal with torn-tail-tolerant
readers, or the atomic temp+`os.replace` snapshot — and nothing but
convention stopped the next subsystem (the serve daemon, store
compaction) from writing a torn file that silently loses a verdict.
These rules prove the protocols statically against the
`contracts.STORE_ARTIFACTS` registry, over the file-effect analysis
in `fileflow.py`:

  * JT-DUR-001 — a store-rooted path not declared in the registry;
  * JT-DUR-002 — a snapshot/marker artifact published without
    temp+`os.replace`;
  * JT-DUR-003 — an append handle whose last write is never flushed,
    or a record split across multiple `write()` calls;
  * JT-DUR-004 — a journal/spool read that bypasses the shared
    torn-tail seal/skip reader;
  * JT-DUR-005 — an append-forever artifact with no declared
    retention class;
  * JT-DUR-006 — the generated README "Store durability" table
    drifted from the registry (`python -m jepsen_tpu_torch.lint --tables`).

The mutation harness (tests/test_durability_prover.py) seeds each
violation into a copy of the real modules and asserts exactly its
rule fires — the prover is itself proved, the JT-ABI precedent.
"""

from __future__ import annotations

from typing import Iterator

from . import Finding, ModuleCtx, ModuleRule, ProjectCtx, ProjectRule
from . import contracts, fileflow

_JOURNALISH = ("journal", "spool")
_ATOMIC = ("snapshot", "marker")


def _sanctioned(rel: str, qualname: str, specs: tuple[str, ...]) -> bool:
    return f"{rel}:{qualname}" in specs


class UndeclaredStoreArtifact(ModuleRule):
    id = "JT-DUR-001"
    doc = ("a store-rooted (or cache-rooted) file path whose name is "
           "not declared in the STORE_ARTIFACTS registry — an on-disk "
           "format with no certified crash-consistency protocol")
    hint = ("declare the artifact (pattern, protocol, writers, "
            "readers, retention) in lint/contracts.py STORE_ARTIFACTS "
            "and regenerate the README table (python -m jepsen_tpu_torch.lint --tables)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for sc in fileflow.analyze(ctx).scopes:
            for node, tail, _root in sc.joins:
                # directories (no dot) are namespace, not artifacts;
                # `.tmp` names are the atomic publishes' scratch
                if "." not in tail or tail.endswith(".tmp"):
                    continue
                if contracts.artifact_for_name(tail) is None:
                    yield self.finding(
                        ctx, node,
                        f"store-rooted artifact {tail!r} is not "
                        "declared in STORE_ARTIFACTS")


class NonAtomicSnapshotPublish(ModuleRule):
    id = "JT-DUR-002"
    doc = ("a snapshot/marker-class artifact written directly on its "
           "final name (`open(path, 'w')` / `.write_text`) instead of "
           "temp+`os.replace` — a crash mid-write leaves a torn file "
           "where a reader expects a complete one")
    hint = ("publish via trace.atomic_write_text (or write a .tmp "
            "sibling and os.replace it over the final name)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for sc in fileflow.analyze(ctx).scopes:
            for node, tail, mode in sc.opens:
                if tail is None or not any(c in mode for c in "wxa+"):
                    continue
                art = contracts.artifact_for_name(tail)
                if art is not None and art.protocol in _ATOMIC:
                    yield self.finding(
                        ctx, node,
                        f"{art.protocol} artifact {tail!r} opened "
                        f"for writing ({mode!r}) on its final name")
            for node, tail in sc.write_texts:
                art = contracts.artifact_for_name(tail)
                if art is not None and art.protocol in _ATOMIC:
                    yield self.finding(
                        ctx, node,
                        f"{art.protocol} artifact {tail!r} published "
                        "via a direct write on its final name")


class UnflushedJournalAppend(ModuleRule):
    id = "JT-DUR-003"
    doc = ("an append-mode handle whose last write() is never "
           "flush()ed (an explicit close() counts — it drains the "
           "buffer and ends observability; the implicit with-exit "
           "does not) before the handle can be observed (returned, "
           "stored, or the process dies), or a record assembled "
           "across multiple write() calls — either way a crash "
           "tears or loses the record (the journal protocol is one "
           "write per line, flushed as it lands)")
    hint = ("build the full line (json.dumps(rec) + '\\n'), write it "
            "with ONE write(), and flush() immediately after")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for sc in fileflow.analyze(ctx).scopes:
            for key, evs in sc.handles.items():
                # one lexical sweep: `last_w` is the most recent write
                # with no flush after it — a bare-"\n" write while one
                # is pending is a record split across two writes, and
                # a pending write at scope end is the unflushed tail
                last_w = None
                for _line, kind, node, is_nl in evs:
                    if kind in ("flush", "close"):
                        # an explicit close() drains the buffer and
                        # ends observability — the with-exit close is
                        # deliberately NOT tracked (a loop of buffered
                        # writes inside a with-block still loses them
                        # all on a mid-loop crash)
                        last_w = None
                    elif kind == "write":
                        if is_nl and last_w is not None:
                            yield self.finding(
                                ctx, node,
                                f"record on append handle {key!r} is "
                                "split across multiple write() calls "
                                "— a crash between them tears the "
                                "line mid-record")
                        last_w = node
                if last_w is not None:
                    yield self.finding(
                        ctx, last_w,
                        f"append handle {key!r}: no flush() after "
                        "its last write() — the record is lost (or "
                        "torn) if the process dies with it buffered")


class RawJournalReader(ModuleRule):
    id = "JT-DUR-004"
    doc = ("a journal/spool-class artifact read with raw json.loads "
           "over raw lines instead of the shared torn-tail seal/skip "
           "reader — a crash-torn tail poisons the load instead of "
           "being skipped")
    hint = ("read through the artifact's declared reader "
            "(VerdictJournal.load / load_costdb / load_events / "
            "load_spool) — they skip the torn tail")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for sc in fileflow.analyze(ctx).scopes:
            if not sc.has_json_loads:
                continue
            reads = list(sc.read_texts)
            for node, tail, mode in sc.opens:
                if tail is not None \
                        and not any(c in mode for c in "wxa+"):
                    reads.append((node, tail))
            for node, tail in reads:
                art = contracts.artifact_for_name(tail)
                if art is None or art.protocol not in _JOURNALISH:
                    continue
                if _sanctioned(ctx.rel, sc.qualname, art.readers):
                    continue
                yield self.finding(
                    ctx, node,
                    f"raw read of {art.protocol} artifact {tail!r} "
                    "bypasses its torn-tail-tolerant reader")


class UndeclaredRetention(ProjectRule):
    id = "JT-DUR-005"
    doc = ("an append-forever (journal/spool) artifact in the "
           "STORE_ARTIFACTS registry with no declared retention "
           "class — unbounded growth with nobody owning the bound "
           "(the static half of ROADMAP item 5's retention lever)")
    hint = ("declare one of contracts.RETENTION_CLASSES on the "
            "registry entry (and make it true: rotation, merge, or "
            "per-sweep cleanup)")

    _REL = "jepsen_tpu_torch/lint/contracts.py"

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        for a in contracts.STORE_ARTIFACTS:
            if a.protocol in _JOURNALISH \
                    and a.retention not in contracts.RETENTION_CLASSES:
                yield Finding(
                    self.id, self._REL, 1,
                    f"{a.protocol} artifact {a.name!r} declares no "
                    f"valid retention class (got {a.retention!r})",
                    self.hint)
            elif a.retention is not None \
                    and a.retention not in contracts.RETENTION_CLASSES:
                yield Finding(
                    self.id, self._REL, 1,
                    f"artifact {a.name!r} declares unknown retention "
                    f"class {a.retention!r}", self.hint)


class DurTableDrift(ProjectRule):
    id = "JT-DUR-006"
    doc = ("the committed README \"Store durability\" table must "
           "match the STORE_ARTIFACTS registry render exactly")
    hint = "regenerate: python -m jepsen_tpu_torch.lint --tables"

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        readme = ctx.root / "README.md"
        if not readme.is_file():
            return   # installed-package context: nothing to check
        text = readme.read_text(encoding="utf-8")
        if contracts.DUR_BEGIN not in text \
                or contracts.DUR_END not in text:
            yield Finding(self.id, "README.md", 1,
                          "store-durability table markers missing "
                          f"({contracts.DUR_BEGIN!r})", self.hint)
            return
        start = text.index(contracts.DUR_BEGIN)
        end = text.index(contracts.DUR_END) + len(contracts.DUR_END)
        line = text[:start].count("\n") + 1
        if text[start:end].strip() != contracts.render_dur_block().strip():
            yield Finding(self.id, "README.md", line,
                          "store-durability table drifted from the "
                          "STORE_ARTIFACTS registry", self.hint)


RULES = [UndeclaredStoreArtifact(), NonAtomicSnapshotPublish(),
         UnflushedJournalAppend(), RawJournalReader(),
         UndeclaredRetention(), DurTableDrift()]

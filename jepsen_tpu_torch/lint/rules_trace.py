"""JT-TRACE — tracer/span, metric-name, obs-event and trace-spool
discipline.

Spans must be context-managed (`with trace.span(...)`): a span object
held open across an exception never records, and manual enter/exit
splits the pairing the Chrome exporter depends on. Counter/gauge/
histogram names must come from the declared registry in
`jepsen_tpu_torch.trace` (`DECLARED_METRICS` / `METRIC_PREFIXES`): the
metrics surface is keyed by string, so one typo silently forks a
series (`quarantined` vs `quarentined`) and every dashboard/bench
diff downstream reads half the events. Flight-recorder events must go
through the typed `obs.emit` API with a kind declared in
`obs.events.EVENT_KINDS` — an ad-hoc dict append to `events.jsonl`
(or a typoed kind) forks the event stream exactly the way an
undeclared metric forks a series. Worker trace spools
(`trace-<pid>.jsonl`) are a wire format owned end to end by
`jepsen_tpu_torch.trace` (writer, loader, merger): a module hand-rolling
the path or the line format forks the spool protocol the same way —
the merge would silently skip (or mis-parse) its files.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from . import Finding, ModuleCtx, ModuleRule, const_str

_TRACE_FILE = "jepsen_tpu_torch/trace.py"
_RECEIVERS = {"trace", "tr", "tracer", "jtrace"}
_METRIC_KINDS = {"counter": "counters", "gauge": "gauges",
                 "histogram": "histograms"}


def _metric_calls(tree: ast.AST) -> Iterator[tuple[ast.Call, str]]:
    """(call, kind) for tracer metric constructor calls with exactly
    one positional argument on a tracer-ish receiver."""
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _METRIC_KINDS \
                and len(n.args) == 1 and not n.keywords \
                and isinstance(n.func.value, ast.Name) \
                and n.func.value.id in _RECEIVERS:
            yield n, n.func.attr


class SpanNotContextManaged(ModuleRule):
    id = "JT-TRACE-001"
    doc = ("a span created outside a `with` statement — it never "
           "records on exceptions and breaks the exporter's pairing")
    hint = "use `with trace.span(name, **args): ...`"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if ctx.rel.endswith(_TRACE_FILE):
            return
        with_exprs: set[int] = set()
        for n in ast.walk(ctx.tree):
            if isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    with_exprs.add(id(item.context_expr))
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "span" \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id in _RECEIVERS \
                    and id(n) not in with_exprs:
                yield self.finding(ctx, n,
                                   "span() not used as a context manager")


class UndeclaredMetricName(ModuleRule):
    id = "JT-TRACE-002"
    doc = ("counter/gauge/histogram name not in the declared registry "
           "(trace.DECLARED_METRICS) — a typo silently forks a "
           "metrics series")
    hint = ("declare the name in trace.DECLARED_METRICS (or fix the "
            "typo); dynamic names must start with a declared "
            "METRIC_PREFIXES entry")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if ctx.rel.endswith(_TRACE_FILE):
            return
        from .. import trace
        declared = trace.DECLARED_METRICS
        prefixes = trace.METRIC_PREFIXES
        all_names = frozenset().union(*declared.values())
        for call, kind in _metric_calls(ctx.tree):
            arg = call.args[0]
            name = const_str(arg)
            if name is not None:
                if name in declared[_METRIC_KINDS[kind]]:
                    continue
                if name in all_names:
                    yield self.finding(
                        ctx, call,
                        f"{name!r} is declared as a different metric "
                        f"kind than {kind}")
                elif any(name.startswith(p) for p in prefixes):
                    continue
                else:
                    yield self.finding(
                        ctx, call, f"undeclared {kind} name {name!r}")
            elif isinstance(arg, ast.JoinedStr):
                lead = arg.values[0] if arg.values else None
                lit = const_str(lead) if lead is not None else None
                if lit is None or not any(lit.startswith(p) or
                                          p.startswith(lit)
                                          for p in prefixes):
                    yield self.finding(
                        ctx, call,
                        f"dynamic {kind} name without a declared "
                        "prefix")
            # non-literal names (pass-through aggregation) are out of
            # lexical reach — runtime owns those


_EVENTS_FILE = "jepsen_tpu_torch/obs/events.py"


def _is_emit_call(n: ast.Call) -> bool:
    """Any `*.emit(...)` or bare `emit(...)` call — receiver-agnostic,
    so `from ..obs.events import emit` and aliased chains can't evade
    the kind check (the runtime raises ValueError on an undeclared
    kind, so an evading typo would be a production crash, not a lint
    finding). Only calls whose first argument is a STRING LITERAL are
    considered, which excludes every unrelated local `emit` helper in
    the tree."""
    f = n.func
    return ((isinstance(f, ast.Attribute) and f.attr == "emit")
            or (isinstance(f, ast.Name) and f.id == "emit"))


class AdHocObsEvent(ModuleRule):
    id = "JT-TRACE-003"
    doc = ("flight-recorder events must be emitted via the typed "
           "obs.emit API with a declared kind — ad-hoc events.jsonl "
           "writes (or a typoed kind) fork the event stream")
    hint = ("call obs.emit(<kind>, **fields); declare new kinds in "
            "jepsen_tpu_torch/obs/events.py EVENT_KINDS")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if ctx.rel.endswith(_EVENTS_FILE):
            return
        from ..obs.events import EVENT_KINDS
        for n in ast.walk(ctx.tree):
            # the file name is private to obs/events.py: any other
            # module naming the path is building an ad-hoc writer
            if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and (n.value == "events.jsonl"           # jt-lint: ok JT-TRACE-003 (the rule's own match literal)
                         or n.value.endswith("/events.jsonl")):   # jt-lint: ok JT-TRACE-003 (the rule's own match literal)
                yield self.finding(
                    ctx, n, "ad-hoc events.jsonl path — the flight "
                            "recorder is written only by obs.events")
            elif isinstance(n, ast.Call) and _is_emit_call(n) \
                    and n.args:
                kind = const_str(n.args[0])
                if kind is not None and kind not in EVENT_KINDS:
                    yield self.finding(
                        ctx, n, f"undeclared obs event kind {kind!r}")


#: The spool-name shape trace.py owns (SPOOL_PREFIX + "<pid>.jsonl",
#: or the glob over it). Matches "trace-123.jsonl", "trace-*.jsonl"
#: and path-suffixed forms like "store/trace-9.jsonl".
_SPOOL_RE = re.compile(r"(^|/)trace-[^/]*\.jsonl$")


class AdHocSpoolWrite(ModuleRule):
    id = "JT-TRACE-004"
    doc = ("a `trace-<pid>.jsonl` worker-spool path built outside "
           "jepsen_tpu_torch.trace — the spool naming and line format are "
           "a wire protocol owned by trace.py; an ad-hoc writer or "
           "globber forks it and the merge silently skips its files")
    hint = ("go through the trace API (worker_ctx/ensure_worker_"
            "tracer/flush_worker_spool to write, merge_traces/"
            "iter_spools/load_spool/clean_spools to read — the "
            "naming lives in trace.SPOOL_PREFIX)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if ctx.rel.endswith(_TRACE_FILE):
            return
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                if _SPOOL_RE.search(n.value):
                    yield self.finding(
                        ctx, n, f"ad-hoc spool path {n.value!r}")
            elif isinstance(n, ast.JoinedStr) and n.values:
                parts = [const_str(v) for v in n.values]
                tail = parts[-1]
                # any constant segment ending in a path component that
                # starts "trace-" (covers both f"trace-{pid}.jsonl"
                # and f"{store}/trace-{pid}.jsonl"), with the literal
                # ".jsonl" tail — an interpolated directory prefix
                # can't evade the rule
                if tail is not None and tail.endswith(".jsonl") \
                        and any(p is not None
                                and re.search(r"(^|/)trace-[^/]*$", p)
                                for p in parts[:-1]):
                    yield self.finding(
                        ctx, n, "ad-hoc f-string spool path")


RULES = [SpanNotContextManaged(), UndeclaredMetricName(),
         AdHocObsEvent(), AdHocSpoolWrite()]

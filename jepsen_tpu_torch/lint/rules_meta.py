"""JT-META — the linter's own documentation surface.

The README rule table is GENERATED from the rule registry
(`lint.render_rule_block`, `python -m jepsen_tpu_torch.lint --tables`) the same way the
env-gate table is generated from `gates.py`; this rule fails the run
when the committed table drifts, and tests/test_torch_lint.py additionally
pins the full rule-id list so a rule can't be renumbered or silently
dropped without a visible diff.
"""

from __future__ import annotations

from typing import Iterator

from . import Finding, ProjectCtx, ProjectRule


class RuleTableDrift(ProjectRule):
    id = "JT-META-001"
    doc = ("the committed README rule table must match the rule "
           "registry render exactly")
    hint = "regenerate: python -m jepsen_tpu_torch.lint --tables"

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        from . import RULES_BEGIN, RULES_END, render_rule_block
        readme = ctx.root / "README.md"
        if not readme.is_file():
            return   # installed-package context: nothing to check
        text = readme.read_text(encoding="utf-8")
        if RULES_BEGIN not in text or RULES_END not in text:
            yield Finding(self.id, "README.md", 1,
                          f"rule-table markers missing "
                          f"({RULES_BEGIN!r})", self.hint)
            return
        start = text.index(RULES_BEGIN)
        end = text.index(RULES_END) + len(RULES_END)
        committed = text[start:end].strip()
        line = text[:start].count("\n") + 1
        if committed != render_rule_block().strip():
            yield Finding(self.id, "README.md", line,
                          "rule table drifted from the rule registry",
                          self.hint)


RULES = [RuleTableDrift()]

"""The port's linter (jepsen_tpu_torch.lint) against the reference's.

1. **Fixture parity** — every fixture of tests/lint_fixtures/, placed at
   the same package-relative path under each package of a tmp tree,
   gives the same (line, rule) findings under the port's `lint_paths`
   as under the reference's, and those are the fixture's EXPECT golden.
2. **Self-hosting** — `jepsen_tpu_torch/` is clean against the port's
   own `lint_baseline_torch.json`, with no stale entry, and the port's
   four generated README blocks match their renders.
3. **The engine** — suppressions, the baseline rules, the CLI's exit
   codes and flags, the rule-id table and the gate registry behave as
   tests/test_lint.py and tests/test_gates.py pin them for the
   reference.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from jepsen_tpu import gates as ref_gates
from jepsen_tpu import lint as ref_lint
from jepsen_tpu_torch import cli, gates, lint
from jepsen_tpu_torch.lint import contracts, wireflow

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "lint_fixtures"
_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([A-Z0-9\-,\s]+?)\s*$")

FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*_*.py"))

#: Package-relative homes a fixture is placed at: a plain module, the
#: hot path, the kernel modules (the reference's Pallas module's
#: counterpart is the port's closure_square.py) and the watchdog homes.
HOMES = [
    ("fixture.py", "fixture.py"),
    ("parallel/fixture.py", "parallel/fixture.py"),
    ("shm.py", "shm.py"),
    ("store.py", "store.py"),
    ("supervisor.py", "supervisor.py"),
    ("checker/elle/kernels.py", "checker/elle/kernels.py"),
    ("checker/elle/pallas_square.py", "checker/elle/closure_square.py"),
    ("checker/knossos/fixture.py", "checker/knossos/fixture.py"),
    ("trace.py", "trace.py"),
    ("gates.py", "gates.py"),
]


def expected_of(path: Path) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    for i, ln in enumerate(path.read_text().splitlines(), start=1):
        m = _EXPECT_RE.search(ln)
        if m:
            out.extend((i, rid.strip())
                       for rid in m.group(1).split(",") if rid.strip())
    return sorted(out)


def findings_at(linter, root: Path, rel: str, source: str) -> list:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(source)
    return sorted((f.line, f.rule) for f in linter.lint_paths([p], root=root))


@pytest.mark.parametrize("home", HOMES, ids=[h[1] for h in HOMES])
@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_fixture_findings_equal_the_references(tmp_path, fixture, home):
    src = (FIXTURES / fixture).read_text()
    ref_rel, port_rel = home
    mine = findings_at(lint, tmp_path, f"jepsen_tpu_torch/{port_rel}", src)
    ref = findings_at(ref_lint, tmp_path, f"jepsen_tpu/{ref_rel}", src)
    assert mine == ref


@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_fixture_golden_in_the_port_tree(tmp_path, fixture):
    """At a plain module path the port fires exactly the EXPECT golden
    (nothing on a clean twin): every family fires, JT-JAX included."""
    path = FIXTURES / fixture
    got = findings_at(lint, tmp_path, "jepsen_tpu_torch/fixture.py",
                      path.read_text())
    assert got == expected_of(path)
    if fixture.endswith("_bad.py"):
        assert got


def test_kernel_module_item_is_flagged_outside_jit(tmp_path):
    src = "def collect(x):\n    return x.sum().item()\n"
    rel = "jepsen_tpu_torch/checker/elle/closure_square.py"
    assert [r for _, r in findings_at(lint, tmp_path, rel, src)] \
        == ["JT-JAX-001"]
    assert findings_at(lint, tmp_path, "jepsen_tpu_torch/ordinary.py",
                       src) == []


# -- self-hosting ------------------------------------------------------------

def test_package_is_clean_against_its_baseline():
    findings = lint.lint_project(REPO, cache=lint.LintCache(REPO))
    entries = lint.load_baseline(REPO / lint.BASELINE_FILE)
    res = lint.apply_baseline(findings, entries)
    assert res.kept == [], "\n" + "\n".join(f.render() for f in res.kept)
    assert res.stale == [], f"stale baseline entries: {res.stale}"
    assert all(e["reason"].strip() for e in entries)


def test_baseline_is_the_ports_own():
    assert lint.BASELINE_FILE == "lint_baseline_torch.json"
    data = json.loads((REPO / lint.BASELINE_FILE).read_text())
    assert data["entries"] == []


def _block(text: str, begin: str, end: str) -> str:
    assert text.count(begin) == 1 and text.count(end) == 1, begin
    return text[text.index(begin):text.index(end) + len(end)].strip()


def test_readme_blocks_match_their_renders():
    text = (REPO / "README.md").read_text()
    assert _block(text, lint.RULES_BEGIN, lint.RULES_END) \
        == lint.render_rule_block()
    assert _block(text, gates.TABLE_BEGIN, gates.TABLE_END) \
        == gates.render_env_block()
    assert _block(text, contracts.DUR_BEGIN, contracts.DUR_END) \
        == contracts.render_dur_block()
    assert _block(text, wireflow.WIRE_BEGIN, wireflow.WIRE_END) \
        == wireflow.render_wire_block(wireflow.live_registry(REPO))


def test_port_markers_differ_from_the_references():
    pairs = [(lint.RULES_BEGIN, ref_lint.RULES_BEGIN),
             (lint.RULES_END, ref_lint.RULES_END),
             (gates.TABLE_BEGIN, ref_gates.TABLE_BEGIN),
             (gates.TABLE_END, ref_gates.TABLE_END)]
    for mine, ref in pairs:
        assert mine != ref and ref not in mine and mine not in ref
    assert "jepsen_tpu_torch" in gates.TABLE_BEGIN


def test_write_tables_restores_drifted_blocks(tmp_path):
    readme = tmp_path / "README.md"
    text = (REPO / "README.md").read_text()
    at = text.index(lint.RULES_BEGIN)
    drifted = text[:at] + text[at:].replace("| JT-ABI-001 |",
                                            "| JT-ABI-00X |", 1)
    assert drifted != text
    readme.write_text(drifted)
    shutil.copytree(REPO / "jepsen_tpu_torch" / "serve",
                    tmp_path / "jepsen_tpu_torch" / "serve")
    assert lint.write_tables(tmp_path) == [
        "rule table", "env-gate table", "store-durability table",
        "wire-frame table"]
    assert readme.read_text() == text


def test_readme_drift_rules_fire(tmp_path):
    from jepsen_tpu_torch.lint import rules_dur, rules_gates, rules_meta
    (tmp_path / "README.md").write_text(
        "intro\n" + gates.TABLE_BEGIN + "\n| stale |\n" + gates.TABLE_END
        + "\n" + lint.RULES_BEGIN + "\n" + lint.RULES_END + "\n")
    ctx = lint.ProjectCtx(tmp_path, [])
    got = [f.rule for r in (*rules_gates.RULES, *rules_meta.RULES,
                            *rules_dur.RULES)
           if isinstance(r, lint.ProjectRule)
           for f in r.check_project(ctx)]
    assert {"JT-GATE-003", "JT-META-001", "JT-DUR-006"} <= set(got)


# -- suppressions and the baseline --------------------------------------------

def _lint_at(tmp_path: Path, rel: str, source: str) -> list[str]:
    return [r for _, r in findings_at(lint, tmp_path, rel, source)]


def test_inline_suppression_same_line(tmp_path):
    assert _lint_at(
        tmp_path, "pkg/m.py",
        'import os\n'
        'x = os.environ["JEPSEN_TPU_TRACE"]'
        '  # jt-lint: ok JT-GATE-001 (fixture)\n') == []


def test_inline_suppression_line_above_and_family(tmp_path):
    assert _lint_at(
        tmp_path, "pkg/m.py",
        'import os\n'
        '# jt-lint: ok JT-GATE (fixture: family-wide)\n'
        'x = os.environ.get("JEPSEN_TPU_TYPO_GATE")\n') == []


def test_suppression_is_rule_scoped(tmp_path):
    assert _lint_at(
        tmp_path, "pkg/m.py",
        'import os\n'
        'x = os.environ.get("JEPSEN_TPU_TYPO_GATE")'
        '  # jt-lint: ok JT-GATE-001 (wrong rule)\n') == ["JT-GATE-002"]


def test_baseline_requires_reason(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"entries": [
        {"rule": "JT-GATE-001", "path": "x.py", "max": 1, "reason": ""}]}))
    with pytest.raises(ValueError):
        lint.load_baseline(p)


def test_baseline_budget_and_stale():
    f = [lint.Finding("JT-GATE-001", "a.py", i, "m") for i in (1, 2, 3)]
    res = lint.apply_baseline(f, [
        {"rule": "JT-GATE-001", "path": "a.py", "max": 2, "reason": "r"},
        {"rule": "JT-SHM-001", "path": "b.py", "max": 1, "reason": "r"}])
    assert len(res.suppressed) == 2 and len(res.kept) == 1
    assert [e["rule"] for e in res.stale] == ["JT-SHM-001"]


def test_missing_baseline_file_is_empty(tmp_path):
    assert lint.load_baseline(tmp_path / "none.json") == []


def test_stale_baseline_fails_the_run(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(lint, "lint_project", lambda *a, **k: [])
    b = tmp_path / "b.json"
    b.write_text(json.dumps({"entries": [
        {"rule": "JT-GATE-001", "path": "gone.py", "max": 1,
         "reason": "was real once"}]}))
    assert lint.run(root=tmp_path, baseline=str(b)) == 1
    assert "stale baseline entry" in capsys.readouterr().out


def test_bad_baseline_is_a_usage_error(tmp_path, monkeypatch):
    monkeypatch.setattr(lint, "lint_project", lambda *a, **k: [])
    b = tmp_path / "b.json"
    b.write_text(json.dumps({"entries": [{"rule": "JT-GATE-001"}]}))
    assert lint.run(root=tmp_path, baseline=str(b)) == 254


def test_gate_coverage_counts_only_the_ports_tests(tmp_path):
    from jepsen_tpu_torch.lint.rules_gates import GateTestCoverage
    tdir = tmp_path / "tests"
    (tdir / "lint_fixtures").mkdir(parents=True)
    names = "\n".join(gates.GATES)
    # the reference's tests and the fixtures are no coverage
    (tdir / "test_gates.py").write_text(names)
    (tdir / "lint_fixtures" / "test_torch_f.py").write_text(names)
    ctx = lint.ProjectCtx(tmp_path, [])
    assert len(list(GateTestCoverage().check_project(ctx))) \
        == len(gates.GATES)
    (tdir / "test_torch_x.py").write_text(names)
    assert list(GateTestCoverage().check_project(ctx)) == []


# -- the CLI ------------------------------------------------------------------

def test_cli_lint_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    bad = tmp_path / "bad.py"
    bad.write_text('import os\nx = os.environ["JEPSEN_TPU_TRACE"]\n')
    assert cli.main(["lint", str(clean)]) == 0
    assert cli.main(["lint", str(bad)]) == 1
    assert "JT-GATE-001" in capsys.readouterr().out
    assert cli.main(["lint", "--no-such-flag"]) == 254
    assert cli.main(["lint", "--format", "yaml"]) == 254


def test_cli_lint_json_and_list_rules(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text('import os\nx = os.environ["JEPSEN_TPU_TRACE"]\n')
    assert cli.main(["lint", "--format", "json", str(bad)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in out["findings"]] == ["JT-GATE-001"]
    assert out["findings_by_family"]["JT-GATE"] == 1
    assert out["rules"] == len(lint.rule_ids())
    assert cli.main(["lint", "--list-rules", "--format", "json"]) == 0
    assert [r["id"] for r in json.loads(capsys.readouterr().out)] \
        == lint.rule_ids()


def test_cli_lint_changed_runs_the_project_rules(tmp_path, capsys):
    """`--changed` outside a git checkout degrades to the full pass;
    either way the exit code follows the findings."""
    (tmp_path / "jepsen_tpu_torch").mkdir()
    (tmp_path / "jepsen_tpu_torch" / "m.py").write_text("x = 1\n")
    rc = lint.run(root=tmp_path, changed=True)
    assert rc == 0, capsys.readouterr()


def test_direct_entry_point(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    for mod in ("jepsen_tpu_torch.lint", "jepsen_tpu_torch.cli"):
        argv = [sys.executable, "-m", mod] + (
            ["lint"] if mod.endswith("cli") else []) + [str(clean)]
        p = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                           timeout=120)
        assert p.returncode == 0, p.stderr[-2000:]
        assert "lint: 0 findings" in p.stdout


def test_rule_ids_are_the_references():
    assert lint.rule_ids() == ref_lint.rule_ids()
    assert len(lint.rule_ids()) == 44


def test_lint_cache_is_the_ports_own(tmp_path):
    p = tmp_path / "jepsen_tpu_torch" / "m.py"
    p.parent.mkdir()
    p.write_text('import os\nx = os.environ["JEPSEN_TPU_TRACE"]\n')
    cache = lint.LintCache(tmp_path)
    assert cache.dir.name == ".lintcache-torch"
    first = lint.lint_paths([p], tmp_path, cache=cache)
    again = lint.lint_paths([p], tmp_path, cache=lint.LintCache(tmp_path))
    assert first == again and [f.rule for f in first] == ["JT-GATE-001"]


# -- the gate registry ---------------------------------------------------------

#: Every gate of the port, by name — the drift list (adding a gate
#: without touching this file fails here and in JT-GATE-004).
PORT_GATES = [
    "JEPSEN_TPU_TRACE", "JEPSEN_TPU_TRACE_MAX_EVENTS",
    "JEPSEN_TPU_WORKER_TRACE", "JEPSEN_TPU_REPORT",
    "JEPSEN_TPU_JAX_PROFILE", "JEPSEN_TPU_EVENTS_MAX_BYTES",
    "JEPSEN_TPU_HEALTH_INTERVAL_S", "JEPSEN_TPU_METRICS_PORT",
    "JEPSEN_TPU_COSTDB", "JEPSEN_TPU_RESIDENCY_INTERVAL_S",
    "JEPSEN_TPU_KERNEL_STATS", "JEPSEN_TPU_KERNEL_STATS_SAMPLE",
    "JEPSEN_TPU_SERVE_SOCKET", "JEPSEN_TPU_SERVE_PORT",
    "JEPSEN_TPU_SERVE_MAX_QUEUE", "JEPSEN_TPU_SERVE_WEIGHTS",
    "JEPSEN_TPU_SERVE_DRAIN_S", "JEPSEN_TPU_SERVE_RETRY_S",
    "JEPSEN_TPU_FLEET_HEARTBEAT_S", "JEPSEN_TPU_FLEET_FAILOVER_S",
    "JEPSEN_TPU_FLEET_SPILL_DEPTH", "JEPSEN_TPU_PLANNER",
    "JEPSEN_TPU_PLANNER_PATH", "JEPSEN_TPU_MESH", "JEPSEN_TPU_MESH_SHARD",
    "JEPSEN_TPU_MESH_SHARDS", "JEPSEN_TPU_MESH_WAIT_S",
    "JEPSEN_TPU_FUSED_CLASSIFY", "JEPSEN_TPU_PACK_THREAD",
    "JEPSEN_TPU_STRICT", "JEPSEN_TPU_DISPATCH_TIMEOUT_S",
    "JEPSEN_TPU_FAULT_INJECT", "JEPSEN_TPU_BACKEND", "JEPSEN_TPU_FRONTIER",
    "JEPSEN_TPU_NATIVE_INGEST", "JEPSEN_TPU_NATIVE_SPLIT",
    "JEPSEN_TPU_NO_NATIVE", "JEPSEN_TPU_NATIVE_LIB_DIR",
    "JEPSEN_TPU_SHM_INGEST", "JEPSEN_TPU_PIPELINE",
    "JEPSEN_TPU_ENCODE_CACHE", "JEPSEN_TPU_ENCODE_CACHE_WRITE",
    "JEPSEN_TPU_SIDECAR_V2",
]


def test_gate_registry_drift_list():
    assert sorted(gates.GATES) == sorted(PORT_GATES)


@pytest.mark.parametrize("name", PORT_GATES)
@pytest.mark.parametrize("raw", [None, "", "0", "1", "2.5", "junk", " x "])
def test_gate_parses_as_the_references(monkeypatch, name, raw):
    """Every port gate is a reference gate of the same name, kind and
    default, and parses one raw value as the reference does."""
    mine, ref = gates.gate(name), ref_gates.gate(name)
    assert (mine.kind, mine.default_str()) == (ref.kind, ref.default_str())
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    assert gates.get(name) == ref_gates.get(name)
    assert gates.is_set(name) == ref_gates.is_set(name)


def test_export_and_unset(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_STRICT", raising=False)
    gates.export("JEPSEN_TPU_STRICT", True)
    assert gates.get_raw("JEPSEN_TPU_STRICT") == "1"
    gates.unset("JEPSEN_TPU_STRICT")
    assert gates.get_raw("JEPSEN_TPU_STRICT") is None
    with pytest.raises(KeyError):
        gates.unset("JEPSEN_TPU_NOT_A_GATE")
    with pytest.raises(KeyError):
        gates.gate("JEPSEN_TPU_NOT_A_GATE")


def test_residency_interval_follows_its_gate(monkeypatch):
    from jepsen_tpu.obs import device as ref_device
    from jepsen_tpu_torch.obs import device
    for raw, want in ((None, 5.0), ("0", 0.0), ("0.25", 0.25),
                      ("junk", 5.0)):
        if raw is None:
            monkeypatch.delenv("JEPSEN_TPU_RESIDENCY_INTERVAL_S",
                               raising=False)
        else:
            monkeypatch.setenv("JEPSEN_TPU_RESIDENCY_INTERVAL_S", raw)
        assert device.residency_interval_s() == want \
            == ref_device.residency_interval_s()

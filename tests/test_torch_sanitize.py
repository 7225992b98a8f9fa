"""The native layer's dynamic analysis in the port: `_build`'s sanitizer
flavours, the WGL oracle's JEPSEN_TPU_NATIVE_LIB_DIR (held to the
reference's verdicts), the host drives' case builders against the
production libraries (`tools/sanitize_native.py`), and the kernel
script's command lines and cases (`tools/sanitize_kernels.py`). The
real sanitizer drives compile instrumented builds (about 30 s each) and
are marked slow."""

from __future__ import annotations

import random
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu.checker import knossos as rkn
from jepsen_tpu.checker import models as rmodels
from jepsen_tpu_torch import _build
from jepsen_tpu_torch.checker import knossos as pkn
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.checker.elle import native_encode
from jepsen_tpu_torch.checker.knossos import dense
from jepsen_tpu_torch.checker.knossos import kernels as kk
from jepsen_tpu_torch.checker.knossos import synth as ksynth
from jepsen_tpu_torch.tools import sanitize_kernels as sk
from jepsen_tpu_torch.tools import sanitize_native as sn

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ _build

@pytest.mark.parametrize("name", ["hist_encode", "wgl"])
def test_flavour_keys_and_dirs_differ(name):
    prod = _build.library_path(name, "/x/g++")
    asan = _build.library_path(name, "/x/g++", "asan")
    tsan = _build.library_path(name, "/x/g++", "tsan")
    assert prod.parent == _build.BUILD_DIR
    assert asan.parent == _build.BUILD_DIR / "asan"
    assert tsan.parent == _build.BUILD_DIR / "tsan"
    assert len({prod.name, asan.name, tsan.name}) == 3
    assert all(p.name.startswith(f"{name}-") for p in (prod, asan, tsan))


def _fake_compiler(monkeypatch, calls):
    """subprocess.run as g++: records the command and "builds" by
    copying the production library (built for real, once) to -o."""
    real = {n: _build.build(n) for n in ("hist_encode", "wgl")}
    run = subprocess.run

    def fake(cmd, **kw):
        if not str(cmd[0]).endswith("g++"):
            return run(cmd, **kw)
        calls.append(list(cmd))
        out = cmd[cmd.index("-o") + 1]
        shutil.copy(real[Path(cmd[-1]).stem], out)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build.subprocess, "run", fake)


@pytest.mark.parametrize("flavour", ["asan", "tsan"])
def test_flavour_flags_reach_the_compiler(flavour, monkeypatch, tmp_path):
    calls: list = []
    _fake_compiler(monkeypatch, calls)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    lib = _build.build("wgl", sanitize=flavour)
    assert lib.parent == tmp_path / "build" / flavour
    assert (lib.parent / native_encode.WGL_LIB_NAME).read_bytes() \
        == lib.read_bytes()
    (cmd,) = calls
    assert tuple(cmd[1:-3]) == _build.SANITIZE_FLAGS[flavour]
    want = {"asan": ["-fsanitize=address,undefined",
                     "-fno-sanitize-recover=all", "-O1", "-g"],
            "tsan": ["-fsanitize=thread", "-O1", "-g"]}[flavour]
    assert set(want) <= set(cmd) and "-O2" not in cmd
    # a plain load never returns the flavour's build
    plain = _build.load("wgl")
    assert Path(plain._name).parent == tmp_path / "build"
    assert not any("-fsanitize" in a for a in calls[-1])
    assert _build.load("wgl", sanitize=flavour) is not plain


def test_cuda_source_takes_no_flavour():
    for flavour in ("asan", "tsan"):
        with pytest.raises(ValueError, match="CUDA source"):
            _build.build("closure_square", sanitize=flavour)
    with pytest.raises(ValueError, match="unknown sanitizer"):
        _build.build("wgl", sanitize="msan")
    with pytest.raises(ValueError):
        _build.load("wgl", path="/x", sanitize="asan")


# ------------------------------------------------- the WGL's lib dir

def _register_histories(n: int, seed: int) -> list:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = ksynth.synth_register_history(
            n_ops=rng.randrange(4, 60), n_procs=rng.randrange(1, 6),
            n_values=rng.randrange(2, 6), info_prob=0.05,
            seed=rng.randrange(1 << 30), max_pending=4)
        out.append(ksynth.corrupt(h, seed=i) if i % 2 else h)
    return out


def test_wgl_lib_dir_loads_that_copy_with_reference_verdicts(
        tmp_path, monkeypatch):
    shutil.copy(_build.build("wgl"), tmp_path / native_encode.WGL_LIB_NAME)
    monkeypatch.delenv("JEPSEN_TPU_NO_NATIVE", raising=False)
    monkeypatch.setenv("JEPSEN_TPU_NATIVE_LIB_DIR", str(tmp_path))
    L = native_encode.native_lib("wgl", "wgl.cc")
    assert Path(L._name) == tmp_path / native_encode.WGL_LIB_NAME
    verdicts = set()
    for h in _register_histories(16, seed=26):
        for mc in (3, 10_000_000):
            got = pkn._wgl_native(h, mc)
            assert got == rkn._wgl_native(h, mc), h
        v = pkn.wgl(pmodels.cas_register(), h)
        assert v == rkn.wgl(rmodels.cas_register(), h)
        verdicts.add(v["valid?"])
    assert verdicts == {True, False}


def test_wgl_lib_dir_missing_file_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_NO_NATIVE", raising=False)
    monkeypatch.setenv("JEPSEN_TPU_NATIVE_LIB_DIR", str(tmp_path))
    h = _register_histories(1, seed=1)[0]
    with pytest.raises(_build.KernelBuildError):
        pkn._wgl_native(h, 100)
    with pytest.raises(_build.KernelBuildError):
        pkn.wgl(pmodels.cas_register(), h)


def test_no_native_wins_over_the_lib_dir(tmp_path, monkeypatch):
    """JEPSEN_TPU_NO_NATIVE: no library is loaded (not even a missing
    one), the Python engine answers with the reference's verdict."""
    monkeypatch.setenv("JEPSEN_TPU_NO_NATIVE", "1")
    monkeypatch.setenv("JEPSEN_TPU_NATIVE_LIB_DIR", str(tmp_path))
    assert native_encode.native_lib("wgl", "wgl.cc") is None
    for h in _register_histories(4, seed=3):
        assert pkn._wgl_native(h, 100) is None
        assert pkn.wgl(pmodels.cas_register(), h)["valid?"] == \
            rkn.wgl(rmodels.cas_register(), h)["valid?"]


# ------------------------------------------------------ host drives

def test_asan_drive_builders_on_the_production_libs(tmp_path):
    got = sn.asan_drive(native_encode.hist_lib(),
                        native_encode.native_lib("wgl", "wgl.cc"),
                        tmp_path, trials=12, n_cas=8, n_mutex=6)
    assert got["files"] == 15 and got["hostile"] == len(sn.HOSTILE)
    assert got["append"] > 0 and got["wr"] > 0 and got["split"] >= 3
    assert got["sidecar"] == 2 * (got["append"] + got["wr"])
    assert got["wgl"]["cas"] > 0 and got["wgl"]["mutex"] > 0
    assert {1, 3} <= set(got["wgl"]["budgets"])


def test_threaded_and_concurrent_callers_on_the_production_lib(tmp_path):
    (tmp_path / "t").mkdir()
    assert sn.threaded_drive(native_encode.hist_lib(), tmp_path / "t",
                             threads=2, rounds=3) > 0
    got = sn.concurrent_callers(tmp_path, readers=2, runs=2)
    assert got["hit"] == got["miss"] == got["run_dirs"] == 4
    assert got["buckets"] > 1 and got["verdicts"] == 6


def test_sanitized_env_and_child_commands(tmp_path):
    env = sn.sanitized_env("asan", tmp_path)
    pre = env["LD_PRELOAD"].split()
    assert [Path(p).name.split(".so")[0] for p in pre] == \
        ["libasan", "libstdc++"]
    assert env["ASAN_OPTIONS"].startswith("detect_leaks=0:log_path=")
    assert "halt_on_error=1" in env["UBSAN_OPTIONS"]
    assert env["JEPSEN_TPU_NATIVE_LIB_DIR"] == str(_build.BUILD_DIR / "asan")
    assert "JEPSEN_TPU_NO_NATIVE" not in env
    tenv = sn.sanitized_env("tsan", tmp_path)
    assert Path(tenv["LD_PRELOAD"].split()[0]).name.startswith("libtsan")
    assert tenv["TSAN_OPTIONS"].startswith("halt_on_error=1:log_path=")
    replay = sn.child_argv("replay")
    assert replay[1:3] == ["-m", "pytest"]
    assert set(sn.REPLAY_TESTS) <= set(replay)
    assert all((REPO / t).is_file() for t in sn.REPLAY_TESTS)
    assert "-k" not in replay and "--deselect" not in replay
    assert sn.child_argv("tsan")[1:] == ["-m", sn.MODULE, "--child", "tsan"]


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["asan", "tsan", "replay"])
def test_sanitizer_drive_passes(mode):
    proc = subprocess.run([sys.executable, "-m", sn.MODULE, f"--{mode}"],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=1200)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert f"sanitize_native --{mode}: passed" in proc.stdout


# ---------------------------------------------------- kernel script

def test_kernel_tool_argv_and_env():
    argv = sk.tool_argv("/cuda/bin/compute-sanitizer", "racecheck")
    assert argv[:3] == ["/cuda/bin/compute-sanitizer", "--tool",
                        "racecheck"]
    assert argv[argv.index("--error-exitcode") + 1] == str(sk.ERROR_EXIT)
    filters = [argv[i + 1] for i, a in enumerate(argv)
               if a == "--kernel-name"]
    assert filters == [f"kns={k}" for k in
                       ("closure_square_kernel", "dense_warp_kernel",
                        "dense_block_kernel", "frontier_kernel")]
    assert argv[argv.index("-m") + 1:] == [sk.MODULE, "--child",
                                           "racecheck"]
    assert sk.tool_env()["PYTORCH_NO_CUDA_MEMORY_CACHING"] == "1"
    for name in ("closure_square.cu", "knossos_dense.cu",
                 "knossos_frontier.cu"):
        src = (REPO / "jepsen_tpu_torch" / "csrc" / name).read_text()
        assert any(f"{k}(" in src for k in sk.KERNELS)


def test_find_compute_sanitizer_order(tmp_path, monkeypatch):
    for d in ("home", "path"):
        (tmp_path / d / "bin").mkdir(parents=True)
        tool = tmp_path / d / "bin" / "compute-sanitizer"
        tool.write_text("#!/bin/sh\n")
        tool.chmod(0o755)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("PATH", str(tmp_path / "path" / "bin"))
    assert _build.find_cuda_tool("compute-sanitizer") == \
        str(tmp_path / "home" / "bin" / "compute-sanitizer")
    monkeypatch.delenv("CUDA_HOME")
    assert _build.find_cuda_tool("compute-sanitizer") == \
        str(tmp_path / "path" / "bin" / "compute-sanitizer")


def test_kernel_cases_cover_the_edges():
    for tool in sk.TOOLS:
        cs = sk.cases(tool)
        sq = [c for c in cs if c.kernel == "closure_square"]
        sc = [c for c in cs if c.kernel == "knossos_dense_scan"]
        assert {1, 3} <= {c.B for c in sq if c.T < 5120}
        assert {384, 1024} <= {c.T for c in sq}
        assert {c.active for c in sq} == {None, (1, 0), (0, 0)}
        assert {(0, 0)} <= {c.active for c in sq if c.cols}
        assert (256, 384) in {c.cols for c in sq if c.T == 384}
        assert {(1024, 2), (1024, 4), (384, 2)} == \
            {(c.T, c.mp) for c in sq if c.kind == "split"}
        assert any(c.T == 5120 for c in sq) == (tool == "memcheck")
        assert {1, 3, 33} == {c.B for c in sc}
        tiers = {(c.S, c.V): dense.plan_scan(c.S, c.V).tier for c in sc}
        assert tiers[(11, 8)] == "warp" and tiers[(12, 8)] == "block"
        assert tiers[(8, 64)] == "warp" and tiers[(9, 64)] == "block"
        assert {c.stats for c in sc} == {False, True}
        assert any(c.B % 2 and c.B > 1 and tiers[(c.S, c.V)] == "warp"
                   for c in sc)
        # the block tier's scratch past the grid: words beyond 8 a thread
        scratch = [c for c in sc if tiers[(c.S, c.V)] == "block"
                   and dense.plan_scan(c.S, c.V).smem_bytes
                   > 4 * (dense.grid_words(c.S, c.V)[1]
                          + dense.grid_words(c.S, c.V)[0])]
        assert {c.stats for c in scratch} == {False, True}


def test_frontier_cases_cover_the_edges():
    for tool in sk.TOOLS:
        fc = [c for c in sk.cases(tool)
              if c.kernel == "knossos_frontier_scan"]
        variants = {(c.packed, c.stats) for c in fc}
        assert variants == {(True, False), (False, False), (False, True)}
        tiers = {(kk.plan_frontier(c.F, c.S, c.packed).tier, c.packed)
                 for c in fc}
        assert tiers == {(t, p) for t in ("shared", "global")
                         for p in (True, False)}
        assert any(c.blocks and c.blocks < c.B
                   and kk.plan_frontier(c.F, c.S, c.packed).tier == "global"
                   for c in fc)
        assert len({c.label for c in fc}) == len(fc)


@pytest.mark.parametrize("which", ["ragged-range", "split", "odd-scan",
                                   "frontier"])
def test_kernel_cases_run_on_cpu(which):
    """The case builders at their CPU path (plain versions on both
    sides): the ragged column range, the exchange, an odd warp batch
    with ragged, corrupt histories, the frontier's overflowing batch."""
    cs = sk.cases("initcheck")
    pick = {"ragged-range": lambda c: c.cols == (256, 384),
            "split": lambda c: c.kind == "split" and c.T == 384,
            "odd-scan": lambda c: c.kernel == "knossos_dense_scan"
            and c.B == 33 and c.S == 3,
            "frontier": lambda c: c.kernel == "knossos_frontier_scan"
            and c.F == 4}[which]
    chosen = [c for c in cs if pick(c)]
    assert chosen
    plain: dict = {}
    for c in chosen:
        sk.run_case(c, torch.device("cpu"), plain)
    if which == "odd-scan":
        (regs, comp, (valid, _r, _p)), = plain.values()
        steps = (comp >= 0).sum(1)
        assert len(set(steps.tolist())) > 1          # ragged
        assert (comp[:, -3:] < 0).all()              # pad steps
        assert set(valid.tolist()) == {True, False}  # corrupt ones fail
    if which == "frontier":
        for ev, (valid, overflow, *_rest) in plain.values():
            assert bool(overflow.all())              # F = 4 overflows
            assert (ev[:, -3:, 0] == 2).all()        # pad events


class _PlainGuard(sk.Guard):
    """The guard's checks around the plain closure_square on the CPU
    (the C entry points need the card), optionally with a fault: a byte
    one past `out`, or a column written outside the range."""

    def __init__(self, fill, fault=None):
        super().__init__(fill)
        self.fault = fault

    def square(self, m, mT, active=None, cols=None):
        from jepsen_tpu_torch.checker.elle import closure_square as pcs

        B, T, _ = m.shape
        out, outT, ch = pcs.closure_square_ref(m, mT, active, cols=cols)
        g = [self._buf(B * T * T, m.device) for _ in range(2)]
        gch = self._buf(B, m.device)
        c0, c1 = cols or (0, T)
        u8 = torch.uint8
        g[0].inner.view(B, T, T)[:, :, c0:c1] = out[:, :, c0:c1].view(u8)
        g[1].inner.view(B, T, T)[:, c0:c1] = outT[:, c0:c1].view(u8)
        gch.inner.copy_(ch.view(torch.uint8))
        if self.fault == "past":
            g[0].buf[sk.GUARD + B * T * T] ^= 1
        elif self.fault == "outside":
            g[0].inner.view(B, T, T)[:, :, c1] = 0
        return (g[0].inner.view(torch.bool).view(B, T, T),
                g[1].inner.view(torch.bool).view(B, T, T),
                gch.inner.view(torch.bool))


@pytest.mark.parametrize("fault", [None, "past", "outside"])
def test_guard_checks_catch_faults(fault):
    """`run_case` with a guard: the plain version through guarded
    buffers passes; a byte past a buffer or a column outside the range
    fails the case."""
    (case,) = [c for c in sk.cases("memcheck") if c.T == 384
               and c.cols == (0, 256) and c.active is None]
    for fill in sk.FILLS:
        guard = _PlainGuard(fill, fault)
        if fault is None:
            sk.run_case(case, torch.device("cpu"), guard=guard)
        else:
            with pytest.raises(AssertionError, match={
                    "past": "guard bands", "outside": "outside columns"}[
                        fault]):
                sk.run_case(case, torch.device("cpu"), guard=guard)


def test_parse_report():
    ok = "========= COMPUTE-SANITIZER\nsanitize-cases {\"cases\": " \
        "{\"closure_square\": 2}}\n========= ERROR SUMMARY: 0 errors\n"
    rep = sk.parse_report(ok)
    assert rep["errors"] == 0 and not rep["refused"]
    assert rep["child"] == {"cases": {"closure_square": 2}}
    race = "========= Error: Race reported between Write access at " \
        "closure_square_kernel(...)+0x40\n========= RACECHECK SUMMARY: " \
        "1 hazard displayed (1 error, 0 warnings)\n"
    rep = sk.parse_report(race)
    assert (rep["errors"], rep["warnings"]) == (1, 0)
    assert rep["named"]["closure_square_kernel"] == 1
    refused = "========= Error: Device not supported. Please refer\n" \
        "========= ERROR SUMMARY: 3 errors\n"
    rep = sk.parse_report(refused)
    run = sk.ToolRun("memcheck", 86, 1.0, rep["errors"], rep["warnings"],
                     rep["refused"], rep["named"], {"x": 1}, "log")
    assert rep["refused"] and not run.ok
    clean = sk.ToolRun("memcheck", 0, 1.0, 0, None, False,
                       dict.fromkeys(sk.KERNELS, 0), {"x": 1}, "log")
    assert clean.ok

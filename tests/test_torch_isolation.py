"""The port stands alone: jepsen_tpu_torch and chip_smoke.py import
neither jax nor jepsen_tpu, entry points default to CUDA and refuse to
run without it, and a kernel build that cannot happen raises instead of
handing back the plain version."""

import ast
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu_torch import _build
from jepsen_tpu_torch.devices import DeviceUnavailable, resolve_device

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "jepsen_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "jepsen_tpu")


def port_sources() -> list[Path]:
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_module_imports_with_jax_and_reference_blocked():
    code = f"""
import importlib, importlib.util, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
import jepsen_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__,
                                              "jepsen_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(REPO / "chip_smoke.py")!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)        # main() stays unrun
assert callable(smoke.main)
print(" ".join(mods))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = set(proc.stdout.split())
    assert len(mods) >= 19
    # the edge-matrix path's modules (scipy, never the reference's
    # native library)
    assert {f"jepsen_tpu_torch.checker.elle.{m}"
            for m in ("graph", "condense", "wr")} <= mods
    # the register path's modules (the WGL library is the port's own
    # build of csrc/wgl.cc, never the reference's)
    assert {f"jepsen_tpu_torch.checker.knossos.{m}"
            for m in ("dense", "encode", "kernels", "packed", "synth")} \
        | {"jepsen_tpu_torch.checker.models",
           "jepsen_tpu_torch.independent"} <= mods


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, node.lineno, n)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        resolve_device(None)
    with pytest.raises(DeviceUnavailable):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def _no_nvcc_env(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at its default prefix")


def test_build_raises_when_nvcc_is_missing(monkeypatch, tmp_path):
    _no_nvcc_env(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.find_nvcc() is None
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("closure_square")


def test_build_raises_with_compiler_output_when_nvcc_fails(monkeypatch,
                                                           tmp_path):
    _no_nvcc_env(monkeypatch, tmp_path)
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no such target sm_90a' >&2\n"
                    "exit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="no such target"):
        _build.build("closure_square")
    assert not any((tmp_path / "build").iterdir())


def test_build_key_follows_source_and_flags(monkeypatch, tmp_path):
    a = _build.library_path("closure_square", "/x/nvcc")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    b = _build.library_path("closure_square", "/x/nvcc")
    assert a != b and a.parent == b.parent == _build.BUILD_DIR


def test_chip_smoke_refuses_without_cuda():
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_VISIBLE_DEVICES",)}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

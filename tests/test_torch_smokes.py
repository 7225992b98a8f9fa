"""The port's smoke and gate scripts, each run as its own `python -m`
child process on the CPU, as a user runs them.

`python -m jepsen_tpu_torch.obs.smoke`, `.serve.smoke`,
`.serve.fleet_smoke` and `python -m jepsen_tpu_torch.warm_bench`, with
`--device cpu`, each exit 0 with the reference's contract met. (The
scripts start pools of spawned workers; a pytest-xdist worker's
`__main__` has no file to re-import, so they never run inside the
test process.) tests/test_torch_smoke_breaches.py seeds a breach
into each and holds it to exit 1.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

#: (module, the line its success prints)
SCRIPTS = [
    ("jepsen_tpu_torch.obs.smoke", "obs-smoke: OK"),
    ("jepsen_tpu_torch.serve.smoke", "serve-smoke: PASS"),
    ("jepsen_tpu_torch.serve.fleet_smoke", "fleet-smoke: PASS"),
    ("jepsen_tpu_torch.warm_bench", "bench-warm: OK"),
]


def child_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JEPSEN_TPU_")}
    env["PYTHONPATH"] = str(REPO)
    return env


def run(argv: list, cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *argv], cwd=cwd,
                          env=child_env(), capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("module,ok_line", SCRIPTS,
                         ids=[m.rsplit(".", 1)[-1] for m, _ in SCRIPTS])
def test_script_passes_on_the_cpu(tmp_path, module, ok_line):
    p = run(["-m", module, "--device", "cpu"], tmp_path)
    out = p.stdout + p.stderr
    assert p.returncode == 0, out[-4000:]
    assert ok_line in out
    assert "FAIL" not in p.stdout


def test_scripts_default_to_cuda_and_refuse_without_it(tmp_path):
    """No `--device`: cuda, which this machine lacks, so the sweep or
    the daemon refuses (non-zero) instead of running on the CPU."""
    p = run(["-m", "jepsen_tpu_torch.warm_bench"], tmp_path)
    assert p.returncode != 0
    assert "cuda" in (p.stdout + p.stderr).lower()


@pytest.mark.parametrize("module", [m for m, _ in SCRIPTS])
def test_script_rejects_an_unknown_device(tmp_path, module):
    p = run(["-m", module, "--device", "tpu"], tmp_path)
    assert p.returncode == 2
    assert "invalid choice" in p.stderr

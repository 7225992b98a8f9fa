"""Each smoke and gate script of the port fails (exit 1, the failing
contract printed) when a breach is seeded into the run it checks.

Each script runs as its own child process, from a small wrapper file
that patches one thing and then calls the script's `main` (a file, so
spawned pool workers can re-import it; the patch sits under
`__name__ == "__main__"`, so the workers stay unpatched):

  * obs smoke — the flight recorder drops the `sweep_end` line;
  * serve smoke — a tenant's verdict journal loses its last line after
    the drain;
  * fleet smoke — one streamed verdict diverges from the checker's
    (every time the client hands it over);
  * warm_bench — a sidecar vanishes after the cold run, so a warm run
    encodes again.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from test_torch_smokes import REPO, child_env

PATCHES = {
    "obs": ("jepsen_tpu_torch.obs.smoke", """
        from jepsen_tpu_torch import obs
        emit = obs.emit
        def dropping(kind, **fields):
            if kind != "sweep_end":
                return emit(kind, **fields)
        obs.emit = dropping
        """, "flight recorder incomplete"),
    "serve": ("jepsen_tpu_torch.serve.smoke", """
        from jepsen_tpu_torch import store
        path_of = store.tenant_journal_path
        def truncating(base, tenant):
            p = path_of(base, tenant)
            lines = p.read_text().splitlines(keepends=True)
            p.write_text("".join(lines[:-1]))
            return p
        store.tenant_journal_path = truncating
        """, "FAIL fleetA journal holds exactly its ids"),
    "fleet": ("jepsen_tpu_torch.serve.fleet_smoke", """
        from jepsen_tpu_torch.serve import client
        collect = client.ServeClient.collect
        flipped = []
        def diverging(self, *a, **kw):
            got = collect(self, *a, **kw)
            if got and not flipped:
                flipped.append(sorted(got)[0])
            for k in flipped:
                if k in got:
                    got[k] = {**got[k], "valid?": "diverged"}
            return got
        client.ServeClient.collect = diverging
        """, "byte-identical to analyze-store"),
    "warm": ("jepsen_tpu_torch.warm_bench", """
        import subprocess
        from pathlib import Path
        run = subprocess.run
        def after_cold(argv, *a, **kw):
            p = run(argv, *a, **kw)
            if "--child" in argv and not getattr(after_cold, "done", 0):
                after_cold.done = 1
                store = Path(argv[argv.index("--child") + 1])
                victim = sorted(store.rglob("encoded*.bin"))[0]
                victim.unlink()
            return p
        subprocess.run = after_cold
        """, "re-encoded 1 run(s)"),
}


@pytest.mark.parametrize("which", sorted(PATCHES))
def test_seeded_breach_fails_the_script(tmp_path, which):
    module, patch, reason = PATCHES[which]
    wrapper = tmp_path / f"breach_{which}.py"
    body = textwrap.indent(textwrap.dedent(patch), "    ")
    wrapper.write_text(
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "if __name__ == '__main__':\n"
        f"{body}\n"
        f"    script = importlib.import_module({module!r})\n"
        "    sys.exit(script.main(['--device', 'cpu']))\n")
    p = subprocess.run([sys.executable, str(wrapper)], cwd=tmp_path,
                       env=child_env(), capture_output=True, text=True,
                       timeout=600)
    out = p.stdout + p.stderr
    assert p.returncode == 1, out[-4000:]
    assert reason in out, out[-4000:]

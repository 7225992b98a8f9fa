"""The port stands alone: jepsen_tpu_torch and chip_smoke.py import
neither jax nor jepsen_tpu, entry points default to CUDA and refuse to
run without it, and a kernel build that cannot happen raises instead of
handing back the plain version."""

import ast
import json
import os
import re
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
    # the stored-checker path's modules (copies of the reference's
    # jax-free core.analyze and fressian codec, never imports of them)
    assert {"jepsen_tpu_torch.core", "jepsen_tpu_torch.fressian",
            "jepsen_tpu_torch.store"} <= mods
    # the single-run checker stack's modules
    assert {"jepsen_tpu_torch.util", "jepsen_tpu_torch.checker.perf",
            "jepsen_tpu_torch.checker.timeline",
            "jepsen_tpu_torch.checker.linear_svg",
            "jepsen_tpu_torch.checker.elle.artifacts"} <= mods
    # the device cost observatory, the live telemetry and the planner
    assert {"jepsen_tpu_torch.obs.device", "jepsen_tpu_torch.obs.health",
            "jepsen_tpu_torch.obs.prom", "jepsen_tpu_torch.planner",
            "jepsen_tpu_torch.parallel.residency",
            "jepsen_tpu_torch.parallel.folding"} <= mods
    # the verdict service: the daemon, the fleet and their wire
    assert {f"jepsen_tpu_torch.serve.{m}"
            for m in ("protocol", "scheduler", "client", "daemon",
                      "fleet")} | {"jepsen_tpu_torch.serve"} <= mods
    # the sharded sweep's coordination
    assert "jepsen_tpu_torch.mesh" in mods
    # the test runner: the harness under core.run and its workloads
    assert {f"jepsen_tpu_torch.{m}"
            for m in ("client", "control", "control.net", "control.util",
                      "os_setup", "db", "net", "generator",
                      "generator.interpreter", "nemesis", "workloads",
                      "workloads.append", "workloads.wr",
                      "workloads.register", "workloads.bank",
                      "workloads.long_fork")} <= mods
    # the suite layer, its SQL wire drivers and the fault bundle
    assert {f"jepsen_tpu_torch.{m}"
            for m in ("suites", "suites.sql", "suites.cockroach",
                      "suites.tidb", "drivers", "drivers.pgwire",
                      "drivers.mysql_wire", "nemesis.clock",
                      "nemesis.combined", "faketime", "faultfs",
                      "workloads.set_workload", "workloads.monotonic",
                      "workloads.causal_reverse", "workloads.adya",
                      "workloads.comments")} <= mods
    # the BASELINE suites (etcd, yugabyte, dgraph), their drivers and
    # the plot checkers
    assert {f"jepsen_tpu_torch.{m}"
            for m in ("suites.etcd", "suites.yugabyte", "suites.ycql",
                      "suites.yugabyte_runner", "suites.dgraph",
                      "drivers.cql", "drivers.dgraph_http",
                      "checker.perf", "checker.clock")} <= mods
    # the last five suites, the chronos checker, the store browser and
    # the repl helpers
    assert {f"jepsen_tpu_torch.{m}"
            for m in ("suites.crate", "suites.logcabin",
                      "suites.elasticsearch", "suites.chronos",
                      "suites.chronos_checker", "suites.charybdefs",
                      "web", "repl")} <= mods


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


#: A module of the JAX package named in a string: `-m jepsen_tpu.x`, an
#: `importlib.import_module("jepsen_tpu.x")` or a spec a subprocess runs.
REFERENCE_MODULE = re.compile(r"(?<![\w.])jepsen_tpu\.[A-Za-z_]")


def docstring_nodes(tree: ast.AST) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def reference_module_strings(src: str) -> list:
    """(line, text) of every string constant but a docstring that names
    a module under `jepsen_tpu.`; docstrings may name the reference's
    files."""
    tree = ast.parse(src)
    docs = docstring_nodes(tree)
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant)
            and isinstance(node.value, str) and id(node) not in docs
            and REFERENCE_MODULE.search(node.value)]


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_string_names_a_reference_module(path):
    """No port module spawns or imports the JAX package by a string (a
    subprocess's `-m jepsen_tpu.suites.yugabyte`, say), which the
    import scan above cannot see."""
    assert reference_module_strings(path.read_text()) == [], path


def test_reference_module_strings_are_found():
    """The scan finds the reference runner's spawn, in a plain string
    and in an f-string, and lets a docstring and the port's own names
    through."""
    spawn = ('"""Runs `python -m jepsen_tpu.suites.yugabyte_runner`."""\n'
             'import sys\n'
             'cmd = [sys.executable, "-m", "jepsen_tpu.suites.yugabyte"]\n'
             'mod = f"jepsen_tpu.suites.{sys.argv[0]}"\n'
             'ok = ["-m", "jepsen_tpu_torch.suites.yugabyte", "jepsen_tpu"]\n')
    assert [ln for ln, _ in reference_module_strings(spawn)] == [3, 4]


def test_yugabyte_runner_spawns_the_ports_suite():
    from jepsen_tpu_torch.suites import yugabyte_runner
    src = Path(yugabyte_runner.__file__).read_text()
    assert '"jepsen_tpu_torch.suites.yugabyte"' in src
    assert reference_module_strings(src) == []


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


def test_pool_worker_imports_no_torch(tmp_path):
    """What a pooled ingest worker runs — `ingest.encode_run_dir`, the
    self-nemesis, the shm export and the trace spool — imports neither
    torch nor jax nor jepsen_tpu: a spawned worker must not pay
    torch's import. Run in a process where all three are blocked."""
    from jepsen_tpu_torch.checker.elle import synth
    for i, T in enumerate((40, 60)):
        d = tmp_path / "store" / f"run-{i}"
        d.mkdir(parents=True)
        hist = synth.synth_append_history(T=T, K=6, seed=i)
        (d / "history.jsonl").write_text(
            "".join(json.dumps(o) + "\n" for o in hist))
    code = f"""
import os, sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
from jepsen_tpu_torch import ingest, shm, supervisor, trace
a, b = {str(tmp_path / "store" / "run-0")!r}, {str(tmp_path / "store" / "run-1")!r}
os.environ["JEPSEN_TPU_SHM_INGEST"] = "1"
enc = ingest.encode_run_dir(a, "append")
assert enc.n > 0
tr = trace.fresh_run("iso", scope="sweep")
tr.spool_dir = {str(tmp_path)!r}
idx, payload, einfo, t0, t1 = ingest._stream_worker(
    (0, b, "append", None, trace.worker_ctx()))
assert not isinstance(payload, Exception), payload
assert einfo["tdigest"]["spans"] >= 1
os.environ["JEPSEN_TPU_FAULT_INJECT"] = "encode:1.0"
try:
    ingest.encode_run_dir(a, "append")
    raise SystemExit("no injected fault")
except supervisor.InjectedFault:
    pass
os.environ["JEPSEN_TPU_FAULT_INJECT"] = "kill:1.0"
try:
    ingest.encode_run_dir(a, "append")   # the parent: degraded to a raise
    raise SystemExit("no injected kill")
except supervisor.InjectedFault as e:
    assert "worker kill" in str(e)
# the single-run checkers share the worker's import path: their
# modules, and building them, load no torch either
from jepsen_tpu_torch import cli, devices, independent, util
from jepsen_tpu_torch.checker import elle, timeline, linear_svg
from jepsen_tpu_torch.checker.elle import artifacts, wr
independent.checker(elle.append_checker(backend="tpu"))
wr.rw_register_checker()
assert devices.resolve_backend("auto") == "tpu"
# so do the live telemetry and the planner's model, which a process
# without a device reads and writes
from jepsen_tpu_torch import obs, planner
from jepsen_tpu_torch.obs import device, health, prom
assert planner.fit_plan([], []) is None
assert prom.render_prometheus(tr).startswith("# TYPE")
assert health.health_snapshot(tr)["v"] == 1
assert "torch" not in [m.split(".")[0] for m in sys.modules
                       if sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok"]


def test_port_shm_module_is_scanned():
    """The AST scan above covers the pool's modules."""
    names = {str(p.relative_to(REPO)) for p in port_sources()}
    assert {"jepsen_tpu_torch/shm.py", "jepsen_tpu_torch/ingest.py",
            "jepsen_tpu_torch/trace.py"} <= names


def test_harness_modules_are_scanned():
    """The AST scan above covers the test runner's modules."""
    names = {str(p.relative_to(REPO)) for p in port_sources()}
    assert {f"jepsen_tpu_torch/{m}.py"
            for m in ("client", "control/__init__", "control/net",
                      "control/util", "os_setup", "db", "net",
                      "generator/__init__", "generator/interpreter",
                      "nemesis/__init__", "workloads/__init__",
                      "workloads/append", "workloads/wr",
                      "workloads/register", "workloads/bank",
                      "workloads/long_fork", "core")} <= names


def test_harness_runs_a_test_without_torch(tmp_path):
    """The test runner's host side — control, generator, interpreter,
    nemesis, net, db, os, core.run and the CLI's `test` — imports
    neither torch nor jax nor jepsen_tpu: a test whose checker needs
    no device runs without torch in the process."""
    code = f"""
import sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
from jepsen_tpu_torch import cli, core, generator as gen, nemesis, net
from jepsen_tpu_torch.workloads import bank
wl = bank.test(accounts=[0, 1], total=0)
rc = cli.run_cli(lambda t, a: {{**t, "name": "iso", "net": net.noop(),
                                "nemesis": nemesis.partition_halves(),
                                "generator": gen.limit(20, wl["generator"]),
                                "checker": wl["checker"]}},
                 argv=["test", "--dummy", "--store", {str(tmp_path)!r}])
assert rc == 0, rc
assert "torch" not in [m.split(".")[0] for m in sys.modules
                       if sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "ok"


def test_serve_modules_import_no_torch():
    """The verdict service's host side — the wire, the admission
    scheduler, the client, the daemon and the fleet router, and the
    store's serve and fleet paths — imports neither torch nor jax nor
    jepsen_tpu: a tenant or a router needs no torch, and the daemon
    imports it only where it resolves its device and dispatches."""
    code = f"""
import sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
from jepsen_tpu_torch.serve import client, daemon, fleet, protocol, scheduler
from jepsen_tpu_torch import store
assert store.shard_of("tA", 3) in (0, 1, 2)
assert store.safe_tenant("../x") != "../x"
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_suite_layer_modules_are_scanned():
    """The AST scan above covers the suite layer, its drivers and the
    fault bundle, and chip_smoke.py."""
    names = {str(p.relative_to(REPO)) for p in port_sources()}
    assert {f"jepsen_tpu_torch/{m}.py"
            for m in ("suites/__init__", "suites/sql", "suites/cockroach",
                      "suites/tidb", "drivers/__init__", "drivers/pgwire",
                      "drivers/mysql_wire", "nemesis/clock",
                      "nemesis/combined", "faketime", "faultfs",
                      "workloads/set_workload", "workloads/monotonic",
                      "workloads/causal_reverse", "workloads/adya",
                      "workloads/comments")} | {"chip_smoke.py"} <= names


def test_baseline_suites_are_scanned():
    """The AST scans above cover the etcd, yugabyte and dgraph suites,
    their drivers and the plot checkers."""
    names = {str(p.relative_to(REPO)) for p in port_sources()}
    assert {f"jepsen_tpu_torch/{m}.py"
            for m in ("suites/etcd", "suites/yugabyte", "suites/ycql",
                      "suites/yugabyte_runner", "suites/dgraph",
                      "drivers/cql", "drivers/dgraph_http",
                      "checker/perf", "checker/clock")} <= names


def test_baseline_suites_import_no_torch():
    """The etcd, yugabyte and dgraph suites, their clients and drivers,
    and the plot checkers import neither torch nor jax nor jepsen_tpu:
    a suite's test map is host code until its checker runs on the
    device."""
    code = f"""
import sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
from jepsen_tpu_torch import checker, suites
from jepsen_tpu_torch.checker import clock, perf
from jepsen_tpu_torch.drivers import cql, dgraph_http
from jepsen_tpu_torch.suites import dgraph, etcd, ycql, yugabyte
from jepsen_tpu_torch.suites import yugabyte_runner
t = etcd.etcd_test({{"faults": ["partition", "kill", "pause", "clock"]}})
assert sorted(t["checker"].checker_map) == ["indep", "perf"]
assert len(yugabyte.all_tests({{}})) == 12
assert dgraph.dgraph_test({{"workload": "delete"}})["client"].mode == \
    "delete"
assert [suites.load_suite(n).__name__.rsplit(".", 1)[1]
        for n in ("etcd", "yugabyte", "dgraph")] == \
    ["etcd", "yugabyte", "dgraph"]
assert "torch" not in [m.split(".")[0] for m in sys.modules
                       if sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_suite_layer_imports_no_torch():
    """The suites, the SQL drivers, the nemeses, faketime and faultfs
    import neither torch nor jax nor jepsen_tpu: a suite's test map, its
    fault package and its clients are host code."""
    code = f"""
import sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
from jepsen_tpu_torch import faketime, faultfs, suites
from jepsen_tpu_torch.drivers import mysql_wire, pgwire
from jepsen_tpu_torch.nemesis import clock, combined
from jepsen_tpu_torch.suites import cockroach, sql, tidb
t = cockroach.cockroach_test({{"faults": ["partition", "kill", "pause",
                                         "clock"], "workload": "bank"}})
assert t["nemesis"].fs >= {{"start-kill", "bump"}}
assert tidb.tidb_test({{"workload": "table"}})["client"].mode == "table"
assert "torch" not in [m.split(".")[0] for m in sys.modules
                       if sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_queue_suites_are_scanned():
    """The AST scans above cover the raftis, rethinkdb, disque, rabbitmq
    and robustirc suites, their RESP, ReQL and AMQP drivers, and the
    queue, causal and cycle workloads."""
    names = {str(p.relative_to(REPO)) for p in port_sources()}
    assert {f"jepsen_tpu_torch/{m}.py"
            for m in ("suites/raftis", "suites/rethinkdb", "suites/disque",
                      "suites/rabbitmq", "suites/robustirc", "drivers/resp",
                      "drivers/reql", "drivers/amqp", "workloads/queue",
                      "workloads/causal", "workloads/cycle")} <= names


def test_queue_suites_import_no_torch():
    """The five suites, their drivers and the queue, causal and cycle
    workloads import neither torch nor jax nor jepsen_tpu: their test
    maps, clients and checkers are host code."""
    code = f"""
import sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
from jepsen_tpu_torch import suites
from jepsen_tpu_torch.drivers import amqp, reql, resp
from jepsen_tpu_torch.workloads import causal, cycle, queue
for name in ("raftis", "rethinkdb", "disque", "rabbitmq", "robustirc"):
    mod = suites.load_suite(name)
    t = getattr(mod, name + "_test")({{}})
    assert t["checker"] is not None and t["client"] is not None, name
assert cycle.checker(lambda h: [(0, 1, "ww"), (1, 0, "ww")]).check(
    {{}}, [{{"type": "ok"}}, {{"type": "ok"}}], {{}})["scc-count"] == 1
assert "torch" not in [m.split(".")[0] for m in sys.modules
                       if sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


#: The aerospike, ignite, hazelcast and faunadb suites and their wire
#: drivers.
WIRE_SUITES = ("suites/aerospike", "suites/ignite", "suites/hazelcast",
               "suites/faunadb", "drivers/aerospike_msg",
               "drivers/ignite_thin", "drivers/hazelcast_proto",
               "drivers/fauna_http")
#: tests/fake_torch_*.py wrapper -> the reference codec it stands in for
PORT_FAKES = {"fake_torch_aerospike": "aerospike_msg",
              "fake_torch_ignite": "ignite_thin",
              "fake_torch_hazelcast": "hazelcast_proto"}


def test_wire_suites_are_scanned():
    """The AST and string scans above cover the four suites and their
    drivers."""
    names = {str(p.relative_to(REPO)) for p in port_sources()}
    assert {f"jepsen_tpu_torch/{m}.py" for m in WIRE_SUITES} <= names


def test_wire_suites_import_no_torch():
    """The four suites and their drivers import neither torch nor jax nor
    jepsen_tpu: their test maps, clients and checkers are host code;
    `util.iso_to_epoch` is the port's."""
    code = f"""
import sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
from jepsen_tpu_torch import suites, util
from jepsen_tpu_torch.drivers import (aerospike_msg, fauna_http,
                                      hazelcast_proto, ignite_thin)
for name, w in (("aerospike", "register"), ("ignite", "bank"),
                ("hazelcast", "queue"), ("faunadb", "multimonotonic")):
    mod = suites.load_suite(name)
    t = getattr(mod, name + "_test")({{"workload": w}})
    assert t["checker"] is not None and t["client"] is not None, name
assert len(aerospike_msg.key_digest("jepsen", 1)) == 20
assert util.iso_to_epoch("1970-01-01T00:00:01.000000001Z") > 1
assert "torch" not in [m.split(".")[0] for m in sys.modules
                       if sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("rel", ["suites/specs/aerospike.tla",
                                 "suites/resources/SetUnionMergePolicy.java"])
def test_wire_suite_resources_are_the_references_bytes(rel):
    assert (PKG / rel).read_bytes() == (REPO / "jepsen_tpu" / rel).read_bytes()


def test_hazelcast_setup_uploads_the_ports_own_merge_policy():
    from jepsen_tpu_torch import control
    from jepsen_tpu_torch.suites import hazelcast
    test = hazelcast.hazelcast_test({"ssh": {"dummy": True},
                                     "nodes": ["n1"]})
    control.on_nodes(test, lambda t, n: t["db"].setup(t, n))
    ups = [p for _n, k, p in test["remote"].actions if k == "upload"]
    assert len(ups) == 1
    local = Path(ups[0][0]).resolve()
    assert local == PKG / "suites" / "resources" / "SetUnionMergePolicy.java"
    assert PKG in local.parents


@pytest.mark.parametrize("wrapper", sorted(PORT_FAKES))
def test_port_fake_wrappers_name_only_their_stand_ins(wrapper):
    """A wrapper imports nothing of jax or the JAX package (AST scan); the
    only reference modules it names are the `sys.modules` keys it stands
    in for while the fake's file executes."""
    path = REPO / "tests" / f"{wrapper}.py"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (node.lineno, n)
    found = {s for _ln, s in reference_module_strings(path.read_text())}
    assert found == {"jepsen_tpu.drivers",
                     f"jepsen_tpu.drivers.{PORT_FAKES[wrapper]}"}


def test_port_fake_wrappers_load_with_jax_and_reference_blocked():
    """With jax and jepsen_tpu blocked, each wrapper loads its fake on the
    port's codec and serves a round trip; afterwards every blocked entry
    is as it was and no other `jepsen_tpu*` module is in `sys.modules`."""
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
import fake_torch_aerospike, fake_torch_hazelcast, fake_torch_ignite
from jepsen_tpu_torch.drivers import (aerospike_msg, hazelcast_proto,
                                      ignite_thin)
with fake_torch_aerospike.FakeAerospikeServer() as s:
    c = aerospike_msg.AsConn("127.0.0.1", s.port)
    c.put(1, {{"value": 7}})
    assert c.get(1)["bins"] == {{"value": 7}}
with fake_torch_ignite.FakeIgniteServer() as s:
    c = ignite_thin.IgniteConn("127.0.0.1", s.port)
    c.put("jepsen", "k", 5)
    assert c.get("jepsen", "k") == 5
with fake_torch_hazelcast.FakeHazelcastServer() as s:
    c = hazelcast_proto.HzConn("127.0.0.1", s.port)
    assert c.queue_offer("q", 3) and c.queue_poll("q") == 3
assert all(sys.modules[n] is None for n in {FORBIDDEN!r})
left = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}
        and m not in {FORBIDDEN!r}]
assert not left, left
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


#: The last five suites, the chronos checker, the store browser and the
#: repl helpers.
LAST_MODULES = ("suites/crate", "suites/logcabin", "suites/elasticsearch",
                "suites/chronos", "suites/chronos_checker",
                "suites/charybdefs", "web", "repl")
#: The jax-free fakes of the control plane (logcabin's TreeOps, the
#: chronos scheduler and its run files).
CONTROL_FAKES = ("fake_torch_treeops", "fake_torch_chronos")


def test_last_suites_are_scanned():
    """The AST and string scans above cover the five suites, the chronos
    checker, web.py and repl.py."""
    names = {str(p.relative_to(REPO)) for p in port_sources()}
    assert {f"jepsen_tpu_torch/{m}.py" for m in LAST_MODULES} <= names


def test_last_suites_import_no_torch():
    """The five suites, the chronos checker, the store browser and the
    repl helpers import neither torch nor jax nor jepsen_tpu: their test
    maps, clients and checkers are host code; every name of SUITES
    loads."""
    code = f"""
import sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
from jepsen_tpu_torch import repl, suites, web
from jepsen_tpu_torch.suites import chronos_checker
for name, w in (("crate", "lost-updates"), ("elasticsearch", "dirty-read"),
                ("chronos", "schedule"), ("charybdefs", None),
                ("logcabin", None)):
    mod = suites.load_suite(name)
    t = getattr(mod, name + "_test")({{"workload": w}} if w else {{}})
    assert t["checker"] is not None and t["client"] is not None, name
assert all(callable(suites.load_suite(n).main) for n in suites.SUITES)
assert repl.decode(repl.encode({{"a": [1, 2]}})) == {{"a": [1, 2]}}
assert callable(web.make_server)
assert "torch" not in [m.split(".")[0] for m in sys.modules
                       if sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("fake", CONTROL_FAKES)
def test_control_fakes_import_nothing_of_jax_or_the_reference(fake):
    path = REPO / "tests" / f"{fake}.py"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (node.lineno, n)
    assert reference_module_strings(path.read_text()) == []


def test_control_fakes_load_with_jax_and_reference_blocked():
    """With jax and jepsen_tpu blocked, the TreeOps remote and the
    chronos fake load and answer the port's clients."""
    code = f"""
import sys, time
for name in {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
import fake_torch_chronos, fake_torch_treeops
from jepsen_tpu_torch.suites import chronos, logcabin
with fake_torch_treeops.FakeTreeOpsRemote() as r:
    test = {{"nodes": ["n1"], "remote": r}}
    c = logcabin.LogCabinClient("n1")
    op = lambda f, v: c.invoke(test, {{"type": "invoke", "f": f,
                                        "value": v, "process": 0}})
    assert op("read", None)["value"] is None
    assert op("write", 3)["type"] == "ok"
    assert op("cas", [3, 4])["type"] == "ok"
    assert op("cas", [3, 1])["error"] == "cas-mismatch"
    assert op("read", None)["value"] == 4
with fake_torch_chronos.FakeChronos() as f:
    test = {{"nodes": ["n1"], "remote": f,
             "db-hosts": {{"n1": ("127.0.0.1", f.port)}}}}
    c = chronos.ChronosClient().open(test, "n1")
    job = {{"name": 1, "start": time.time() - 30, "count": 2,
            "duration": 1, "epsilon": 10, "interval": 60}}
    assert c.invoke(test, {{"type": "invoke", "f": "add-job",
                            "value": job}})["type"] == "ok"
    runs = c.invoke(test, {{"type": "invoke", "f": "read"}})["value"]
    assert [r["name"] for r in runs] == [1] and runs[0]["end"]
left = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}
        and m not in {FORBIDDEN!r}]
assert not left, left
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


#: The smoke and gate scripts, the linter and the native split.
SLICE_23 = (["jepsen_tpu_torch/native_lib.py", "jepsen_tpu_torch/warm_bench.py",
             "jepsen_tpu_torch/obs/smoke.py", "jepsen_tpu_torch/serve/smoke.py",
             "jepsen_tpu_torch/serve/fleet_smoke.py"]
            + sorted(str(p.relative_to(REPO))
                     for p in (PKG / "lint").glob("*.py")))


def test_scripts_lint_and_split_are_scanned():
    scanned = {str(p.relative_to(REPO)) for p in port_sources()}
    assert len(SLICE_23) == 5 + 19
    assert set(SLICE_23) <= scanned


def test_lint_imports_no_torch_and_never_its_target():
    """The linter is stdlib-only: with torch, jax and jepsen_tpu blocked
    it loads every rule and lints the port's own sources (the gate and
    metric registries it reads are torch-free)."""
    code = f"""
import sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from jepsen_tpu_torch import lint
from jepsen_tpu_torch.lint import rules_abi
mod, proj = lint.all_rules()
files = sorted(Path({str(PKG)!r}).rglob("*.py"))
assert lint.lint_paths(files, Path({str(REPO)!r})) == []
ctx = lint.ProjectCtx(Path({str(REPO)!r}), [])
assert [f for r in rules_abi.RULES for f in r.check_project(ctx)] == []
print(len(mod) + len(proj))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == 44


def test_scripts_and_split_load_with_jax_and_reference_blocked():
    code = f"""
import importlib, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(REPO)!r})
for m in ("jepsen_tpu_torch.native_lib", "jepsen_tpu_torch.warm_bench",
          "jepsen_tpu_torch.obs.smoke", "jepsen_tpu_torch.serve.smoke",
          "jepsen_tpu_torch.serve.fleet_smoke"):
    assert callable(importlib.import_module(m).__dict__.get(
        "main", getattr(importlib.import_module(m), "split_key_ids", None)))
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"

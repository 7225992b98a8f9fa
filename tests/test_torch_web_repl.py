"""The port's store browser (`web.py`, `serve --web`), its repl helpers
(`repl.py`) and the rest of `util.py` and `history.py`, against the
reference's.

- tests/test_cli_web.py's cases on the port's `cli` and `web`, and
  `python -m jepsen_tpu_torch.cli serve --web` serving a store.
- Both packages' browsers on one store: the same pages, files, zip
  bytes and refusals (the path-traversal guard, unknown routes).
- tests/test_history.py's cases on the port's `history` and `util`,
  and the port's `op`, `invoke_op`, `processes`,
  `longest_common_prefix` and `pad_to_multiple` on seeded inputs, equal
  to the reference's.
- `repl`: `last_test`, `to_file`, `encode` and `decode` as the
  reference's.
"""

import contextlib
import io
import json
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest

import jepsen_tpu.history as ref_h
import jepsen_tpu.repl as ref_repl
import jepsen_tpu.store as ref_store
import jepsen_tpu.util as ref_util
import jepsen_tpu.web as ref_web
from jepsen_tpu_torch import checker as jchecker
from jepsen_tpu_torch import cli, generator as gen, web, workloads
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import repl, util
from jepsen_tpu_torch.store import Store

REPO = Path(__file__).resolve().parent.parent


def make_test_fn(tmp_path):
    def test_fn(base, args):
        db, client = workloads.atom_fixtures()
        return {
            **base,
            "name": "cli-test",
            "nodes": base.get("nodes") or ["n1", "n2"],
            "db": db,
            "client": client,
            "generator": gen.clients(
                gen.limit(20, gen.repeat_gen({"f": "read"}))),
            "checker": jchecker.stats(),
            "store": Store(tmp_path / "store"),
        }

    return test_fn


# ---------------------------------------------------------------------------
# The reference's cases: tests/test_cli_web.py
# ---------------------------------------------------------------------------

def test_cli_test_command(tmp_path, capsys):
    code = cli.run_cli(make_test_fn(tmp_path),
                       argv=["test", "--dummy", "--concurrency", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0
    assert out["valid?"] is True


def test_cli_analyze_command(tmp_path, capsys):
    test_fn = make_test_fn(tmp_path)
    assert cli.run_cli(test_fn, argv=["test", "--dummy"]) == 0
    capsys.readouterr()
    code = cli.run_cli(test_fn, argv=["analyze", "--store",
                                      str(tmp_path / "store")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0
    assert out["valid?"] is True


def test_cli_invalid_exit_code(tmp_path):
    class AlwaysInvalid(jchecker.Checker):
        def check(self, test, history, opts):
            return {"valid?": False}

    def test_fn(base, args):
        t = make_test_fn(tmp_path)(base, args)
        t["checker"] = AlwaysInvalid()
        return t

    assert cli.run_cli(test_fn, argv=["test", "--dummy"]) == 1


def test_cli_usage_error(tmp_path):
    assert cli.run_cli(make_test_fn(tmp_path), argv=["bogus"]) == 254


def get(url: str) -> tuple:
    """(status, body) of a GET."""
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_web_serves_store(tmp_path, capsys):
    cli.run_cli(make_test_fn(tmp_path), argv=["test", "--dummy"])
    store = Store(tmp_path / "store")
    srv = web.make_server(store, "127.0.0.1", 0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        home = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/").read().decode()
        assert "cli-test" in home and "valid" in home
        m = re.search(r"href='/files/([^']+)'", home)
        run = m.group(1)
        listing = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/files/{run}").read().decode()
        assert "history.edn" in listing
        hist = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/files/{run}/history.edn").read()
        assert b":invoke" in hist
        z = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/zip/{run}").read()
        assert z[:2] == b"PK"
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/files/../../etc/passwd")
            raised = False
        except urllib.error.HTTPError as e:
            raised = e.code == 404
        assert raised
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# Both browsers on one store
# ---------------------------------------------------------------------------

@pytest.fixture
def two_runs(tmp_path):
    """A store with two tests' runs (one valid, one invalid), a run
    without results, and a run of a nested file."""
    class AlwaysInvalid(jchecker.Checker):
        def check(self, test, history, opts):
            return {"valid?": False}

    fn = make_test_fn(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.run_cli(fn, argv=["test", "--dummy"]) == 0
        assert cli.run_cli(lambda b, a: {**fn(b, a), "name": "other",
                                         "checker": AlwaysInvalid()},
                           argv=["test", "--dummy"]) == 1
    base = tmp_path / "store"
    bare = base / "bare" / "20260101T000000.000"
    (bare / "sub").mkdir(parents=True)
    (bare / "sub" / "notes.txt").write_text("x & <y>\n")
    (bare / "odd name.log").write_text("log\n")
    return base


PATHS = ("/", "/files/", "/files/cli-test", "/files/bare/20260101T000000.000",
         "/files/bare/20260101T000000.000/sub/notes.txt",
         "/files/bare/20260101T000000.000/odd%20name.log",
         "/zip/bare/20260101T000000.000", "/files/../../etc/passwd",
         "/files/%2e%2e/%2e%2e/etc/passwd", "/zip/../..", "/nope",
         "/files/missing", "/zip/missing")


def serve_both(base: Path):
    """Each package's browser on `base`, in turn; {pkg: {path:
    (status, content type, body)}}, with the first run's listing and
    zip."""
    out = {}
    for name, mk, st in (("ref", ref_web.make_server, ref_store.Store),
                         ("port", web.make_server, Store)):
        srv = mk(st(base), "127.0.0.1", 0)
        port = srv.server_address[1]
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            home = get(f"http://127.0.0.1:{port}/")[1].decode()
            runs = re.findall(r"href='/files/([^']+)'", home)
            got = {}
            for p in [*PATHS, *(f"/files/{r}" for r in runs),
                      *(f"/zip/{r}" for r in runs),
                      *(f"/files/{r}/history.edn" for r in runs)]:
                try:
                    r = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{p}", timeout=10)
                    got[p] = (r.status, r.headers["Content-Type"],
                              r.read())
                except urllib.error.HTTPError as e:
                    got[p] = (e.code, e.headers["Content-Type"], e.read())
            out[name] = got
        finally:
            srv.shutdown()
            srv.server_close()
    return out


def test_both_browsers_serve_the_same_bytes(two_runs):
    out = serve_both(two_runs)
    assert out["port"].keys() == out["ref"].keys()
    for p in out["ref"]:
        assert out["port"][p] == out["ref"][p], p
    port = out["port"]
    home = port["/"][2].decode()
    assert "INVALID" in home and ">valid<" in home and ">?<" in home
    for p in ("/files/../../etc/passwd", "/files/%2e%2e/%2e%2e/etc/passwd",
              "/zip/../..", "/nope", "/files/missing", "/zip/missing"):
        assert port[p][0] == 404, p
    assert port["/files/bare/20260101T000000.000/sub/notes.txt"] == (
        200, "text/plain", b"x & <y>\n")


def test_zip_holds_the_runs_files(two_runs):
    """The zip of a run holds every file of its dir, under
    `<start>/...`, byte for byte."""
    out = serve_both(two_runs)
    for name in ("cli-test", "other"):
        (run,) = [d for d in (two_runs / name).iterdir()
                  if d.is_dir() and d.name != "latest"]
        status, ctype, body = out["port"][f"/zip/{name}/{run.name}"]
        assert (status, ctype) == (200, "application/zip")
        zf = zipfile.ZipFile(io.BytesIO(body))
        files = {str(f.relative_to(run.parent)): f.read_bytes()
                 for f in sorted(run.rglob("*")) if f.is_file()}
        assert sorted(zf.namelist()) == sorted(files)
        assert all(zf.read(n) == b for n, b in files.items())


def test_serve_web_through_the_cli(two_runs, monkeypatch):
    """`serve --web` in run_cli: the browser on --host and --port over
    --store, exit 0 once the server stops."""
    made = []
    real = web.make_server

    def make(store, host="127.0.0.1", port=8080):
        made.append((str(store.base), host, port))
        srv = real(store, host, 0)
        made.append(srv)
        return srv

    monkeypatch.setattr(web, "make_server", make)
    rc = []
    buf = io.StringIO()

    def serve():
        with contextlib.redirect_stdout(buf):
            rc.append(cli.run_cli(lambda t, a: t, argv=[
                "serve", "--web", "--store", str(two_runs), "--host",
                "127.0.0.1", "--port", "8099"]))

    t = threading.Thread(target=serve)
    t.start()
    deadline = time.monotonic() + 10
    while len(made) < 2:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    srv = made[1]
    status, body = get(f"http://127.0.0.1:{srv.server_address[1]}/")
    srv.shutdown()
    t.join(10)
    assert made[0] == (str(two_runs), "127.0.0.1", 8099)
    assert status == 200 and b"cli-test" in body
    assert rc == [0]
    assert buf.getvalue().startswith(
        f"serving {two_runs} on http://127.0.0.1:8099")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_cli_serve_web_serves_the_store(two_runs):
    """`python -m jepsen_tpu_torch.cli serve --web` serves the store
    (it exited 254 before `web.py` was ported) until it is stopped."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "serve", "--web",
         "--store", str(two_runs), "--host", "127.0.0.1", "--port",
         str(port)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                status, body = get(f"http://127.0.0.1:{port}/")
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert status == 200 and b"other" in body and b"cli-test" in body
        assert get(f"http://127.0.0.1:{port}/files/..%2f..%2f")[0] == 404
    finally:
        proc.terminate()
        proc.communicate(timeout=30)


# ---------------------------------------------------------------------------
# The reference's cases: tests/test_history.py
# ---------------------------------------------------------------------------

def mk(type, process, f, value=None, **kw):
    return h.op(type, process, f, value, **kw)


def test_index():
    hist = [mk("invoke", 0, "read"), mk("ok", 0, "read", 5)]
    idx = h.index(hist)
    assert [o["index"] for o in idx] == [0, 1]


def test_pairs_basic():
    hist = [
        mk("invoke", 0, "read"),
        mk("invoke", 1, "write", 3),
        mk("ok", 1, "write", 3),
        mk("ok", 0, "read", 3),
    ]
    ps = list(h.pairs(hist))
    assert len(ps) == 2
    assert ps[0][0]["process"] == 0 and ps[0][1]["type"] == "ok"
    assert ps[1][0]["process"] == 1 and ps[1][1]["value"] == 3


def test_pairs_pending_and_nemesis():
    hist = [
        mk("invoke", 0, "read"),
        mk("info", "nemesis", "start-partition", "majority"),
    ]
    ps = list(h.pairs(hist))
    assert ps[0][1] is None
    assert ps[1][0]["process"] == "nemesis" and ps[1][1] is None


def test_complete_fills_read_values():
    hist = [mk("invoke", 0, "read"), mk("ok", 0, "read", 7)]
    c = h.complete(hist)
    assert c[0]["value"] == 7


def test_remove_failures():
    hist = [
        mk("invoke", 0, "write", 1),
        mk("fail", 0, "write", 1),
        mk("invoke", 1, "write", 2),
        mk("info", 1, "write", 2),
    ]
    r = h.remove_failures(hist)
    assert len(r) == 2
    assert all(o["process"] == 1 for o in r)


def test_edn_roundtrip():
    hist = [
        mk("invoke", 0, "txn", [["append", 1, 2], ["r", 1, None]], time=10),
        mk("ok", 0, "txn", [["append", 1, 2], ["r", 1, [2]]], time=20),
        mk("info", "nemesis", "start-partition", "majority", time=30),
    ]
    back = h.history_from_edn(h.history_to_edn(hist))
    assert back[0]["type"] == "invoke"
    assert back[0]["f"] == "txn"
    assert back[0]["value"] == [["append", 1, 2], ["r", 1, None]]
    assert back[1]["value"][1] == ["r", 1, [2]]
    assert back[2]["process"] == "nemesis"


def test_latencies_and_intervals():
    hist = [
        mk("invoke", 0, "read", time=100),
        mk("ok", 0, "read", 1, time=350),
        mk("info", "nemesis", "start-partition", None, time=400),
        mk("info", "nemesis", "stop-partition", None, time=900),
    ]
    lats = h.history_latencies(hist)
    assert lats[0]["latency"] == 250
    spans = h.nemesis_intervals(hist)
    assert len(spans) == 1
    assert spans[0][0]["time"] == 400 and spans[0][1]["time"] == 900


def test_lazy_atom():
    calls = []

    def init():
        calls.append(1)
        return 10

    a = util.lazy_atom(init)
    outs = []
    ts = [threading.Thread(target=lambda: outs.append(a.deref()))
          for _ in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert outs == [10] * 8 and calls == [1]
    assert a.swap(lambda v, d: v + d, 5) == 15
    assert a.deref() == 15
    a.reset(0)
    assert a.deref() == 0


def test_named_locks():
    locks = util.named_locks()
    assert locks("n1") is locks("n1")
    assert locks("n1") is not locks("n2")
    with locks("n1"):
        assert not locks("n1").acquire(blocking=False)
    assert locks("n1").acquire(blocking=False)
    locks("n1").release()


# ---------------------------------------------------------------------------
# The new helpers against the reference's, on seeded inputs
# ---------------------------------------------------------------------------

def seeded_ops(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    procs = [0, 1, 2, 3, "nemesis", "router"]
    out = []
    for i in range(n):
        kw = {"time": int(rng.integers(0, 10 ** 9))} if rng.integers(
            0, 2) else {}
        if rng.integers(0, 4) == 0:
            kw["error"] = f"e{i}"
        out.append(((h.TYPES[int(rng.integers(0, 4))],
                     procs[int(rng.integers(0, len(procs)))],
                     ["read", "write", "cas", "txn"][int(rng.integers(0,
                                                                      4))],
                     int(rng.integers(0, 5)) if rng.integers(0, 2)
                     else None), kw))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_op_invoke_op_and_processes_equal_the_references(seed):
    assert h.TYPES == ref_h.TYPES == ("invoke", "ok", "fail", "info")
    ops = seeded_ops(seed)
    port = [h.op(*a, **kw) for a, kw in ops]
    ref = [ref_h.op(*a, **kw) for a, kw in ops]
    assert port == ref
    assert [list(o) for o in port] == [list(o) for o in ref]
    port_inv = [h.invoke_op(*a[1:], **kw) for a, kw in ops]
    assert port_inv == [ref_h.invoke_op(*a[1:], **kw) for a, kw in ops]
    assert all(o["type"] == "invoke" for o in port_inv)
    hist = port + [{"type": "ok", "f": "read"}]
    assert h.processes(hist) == ref_h.processes(hist)
    assert h.processes(hist) == {a[1] for a, _ in ops}


@pytest.mark.parametrize("seed", range(8))
def test_longest_common_prefix_and_pad_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    stem = [int(x) for x in rng.integers(0, 4, int(rng.integers(0, 6)))]
    seqs = [stem + [int(x) for x in rng.integers(0, 4, int(
        rng.integers(0, 5)))] for _ in range(int(rng.integers(1, 5)))]
    for s in (seqs, [tuple(x) for x in seqs], [seqs[0]], [],
              ["abcd", "abxy"]):
        assert util.longest_common_prefix(s) == \
            ref_util.longest_common_prefix(s)
    assert util.longest_common_prefix(seqs)[:len(stem)] == stem
    xs = [int(x) for x in rng.integers(0, 9, int(rng.integers(0, 11)))]
    for k in range(0, 6):
        got = util.pad_to_multiple(xs, k)
        assert got == ref_util.pad_to_multiple(xs, k)
        if k > 1 and xs:
            assert len(got) % k == 0 and got[:len(xs)] == xs


def test_lazy_atom_and_named_locks_behave_as_the_references():
    for mod in (util, ref_util):
        a = mod.lazy_atom(lambda: [1])
        a.reset([2])              # reset bypasses initialization
        assert a.deref() == [2]
        assert a.swap(lambda v: v + [3]) == [2, 3]
    assert type(util.lazy_atom(int)).__name__ == "LazyAtom"
    locks = util.named_locks()
    assert locks(("n1", 1)) is locks(("n1", 1))


# ---------------------------------------------------------------------------
# repl
# ---------------------------------------------------------------------------

def test_repl_last_test_equals_the_references(tmp_path):
    assert repl.last_test(tmp_path / "empty") is None
    assert ref_repl.last_test(str(tmp_path / "empty")) is None
    with contextlib.redirect_stdout(io.StringIO()):
        cli.run_cli(make_test_fn(tmp_path), argv=["test", "--dummy"])
    base = tmp_path / "store"
    port = repl.last_test(Store(base))
    ref = ref_repl.last_test(str(base))
    assert port["name"] == ref["name"] == "cli-test"
    assert port["start-time"] == ref["start-time"]
    assert port["history"] == ref["history"]
    assert port["results"] == ref["results"]
    assert repl.last_test(str(base))["history"] == port["history"]


@pytest.mark.parametrize("value", [
    None, 1, -2.5, "s", True, [1, [2, None]], {"a": 1, "b": [1, 2]},
    {"type": "ok", "f": "txn", "value": [["append", 1, 2]]}, set([1, 2]),
    (1, 2)])
def test_repl_codec_equals_the_references(value):
    assert repl.encode(value) == ref_repl.encode(value)
    data = repl.encode(value)
    assert repl.decode(data) == ref_repl.decode(data)
    assert repl.decode(None) is None


def test_repl_to_file_as_the_reference(tmp_path, capsys):
    for name, mod in (("port", repl), ("ref", ref_repl)):
        path = tmp_path / name / "deep" / "report.txt"
        with mod.to_file(path):
            print("inside", name)
        assert path.read_text() == f"inside {name}\n"
        assert capsys.readouterr().out == f"Report written to {path}\n"
    # an unopenable path prints no notice, in both
    for mod in (repl, ref_repl):
        with pytest.raises(IsADirectoryError):
            with mod.to_file(tmp_path):
                pass
    assert capsys.readouterr().out == ""

"""`core.run` and the `test`/`test-all` commands of the port against the
reference's.

- A one-worker run (concurrency 1, a deterministic in-process store, the
  nemesis in a phase of its own) gives the reference's history (times
  removed), run-dir files and bytes, and results.
- Threaded runs of the append, wr, register and bank workloads through
  the port's `core.run` are re-checked by the reference's `analyze` on
  the stored run: the same verdict.
- `test` and `test-all` exit with the reference's codes and print its
  result lines (store paths and start times replaced).
- Without a card a default test map's checker raises DeviceUnavailable
  and `test` exits 255; a kernel failure inside the analysis exits 255;
  both leave the history `save_1` wrote and no verdict.
"""

import json
import re
import shutil
import threading
from pathlib import Path

import pytest
import torch

import jepsen_tpu.checker as ref_checker
import jepsen_tpu.checker.elle as ref_elle
import jepsen_tpu.cli as ref_cli
import jepsen_tpu.client as ref_client
import jepsen_tpu.core as ref_core
import jepsen_tpu.db as ref_db
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.nemesis as ref_nemesis
import jepsen_tpu.net as ref_net
import jepsen_tpu.store as ref_store
import jepsen_tpu.workloads.append as ref_append
import jepsen_tpu.workloads.bank as ref_bank
import jepsen_tpu.workloads.register as ref_register
import jepsen_tpu.workloads.wr as ref_wr
import jepsen_tpu_torch.checker as port_checker
import jepsen_tpu_torch.checker.elle as port_elle
import jepsen_tpu_torch.client as port_client
import jepsen_tpu_torch.core as port_core
import jepsen_tpu_torch.db as port_db
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.nemesis as port_nemesis
import jepsen_tpu_torch.net as port_net
import jepsen_tpu_torch.store as port_store
import jepsen_tpu_torch.workloads.append as port_append
import jepsen_tpu_torch.workloads.bank as port_bank
import jepsen_tpu_torch.workloads.register as port_register
import jepsen_tpu_torch.workloads.wr as port_wr
from jepsen_tpu_torch import _build, cli
from test_torch_cli import reference_env  # noqa: F401

REF = dict(checker=ref_checker, elle=ref_elle, client=ref_client,
           core=ref_core, db=ref_db, gen=ref_gen, ind=ref_ind,
           nemesis=ref_nemesis, net=ref_net, store=ref_store,
           append=ref_append, wr=ref_wr, register=ref_register,
           bank=ref_bank, cli=ref_cli)
PORT = dict(checker=port_checker, elle=port_elle, client=port_client,
            core=port_core, db=port_db, gen=port_gen, ind=port_ind,
            nemesis=port_nemesis, net=port_net, store=port_store,
            append=port_append, wr=port_wr, register=port_register,
            bank=port_bank, cli=cli)
START = "20260101T000000.000"
TIMESTAMP = re.compile(rb"\d{8}T\d{6}\.\d{3}")


# ---------------------------------------------------------------------------
# In-process stores and their clients
# ---------------------------------------------------------------------------

def list_client(P, stale_every: int = 0):
    """A list-append client over one in-process store. Serializable
    unless `stale_every`: then reads see a snapshot of the lists taken
    every `stale_every` txns, missing later txns' appends."""
    lists: dict = {}
    snap: dict = {}
    lock = threading.Lock()
    count = [0]

    class ListClient(P["client"].Client):
        def invoke(self, test, op):
            out = []
            with lock:
                count[0] += 1
                if stale_every and count[0] % stale_every == 1:
                    snap.clear()
                    snap.update({k: list(v) for k, v in lists.items()})
                view = snap if stale_every else lists
                for mf, k, v in op["value"]:
                    if mf == "append":
                        lists.setdefault(k, []).append(v)
                        out.append([mf, k, v])
                    else:
                        out.append(["r", k, list(view.get(k, []))])
            return {**op, "type": "ok", "value": out}

    return ListClient()


def wr_client(P):
    regs: dict = {}
    lock = threading.Lock()

    class WrClient(P["client"].Client):
        def invoke(self, test, op):
            out = []
            with lock:
                for mf, k, v in op["value"]:
                    if mf == "w":
                        regs[k] = v
                        out.append([mf, k, v])
                    else:
                        out.append(["r", k, regs.get(k)])
            return {**op, "type": "ok", "value": out}

    return WrClient()


def keyed_register_client(P):
    """CAS registers, one a key, for `[k v]` lifted ops."""
    regs: dict = {}
    lock = threading.Lock()
    tup = P["ind"].tuple_

    class KeyedClient(P["client"].Client):
        def invoke(self, test, op):
            k, v = op["value"]
            with lock:
                cur = regs.get(k)
                if op["f"] == "read":
                    return {**op, "type": "ok", "value": tup(k, cur)}
                if op["f"] == "write":
                    regs[k] = v
                    return {**op, "type": "ok"}
                old, new = v
                if cur == old:
                    regs[k] = new
                    return {**op, "type": "ok"}
                return {**op, "type": "fail"}

    return KeyedClient()


def bank_client(P, accounts):
    bal = {a: 0 for a in accounts}
    bal[accounts[0]] = 100
    lock = threading.Lock()

    class BankClient(P["client"].Client):
        def invoke(self, test, op):
            with lock:
                if op["f"] == "read":
                    return {**op, "type": "ok", "value": dict(bal)}
                v = op["value"]
                if bal[v["from"]] < v["amount"]:
                    return {**op, "type": "fail"}
                bal[v["from"]] -= v["amount"]
                bal[v["to"]] += v["amount"]
                return {**op, "type": "ok"}

    return BankClient()


def base(P, store: Path, **kw) -> dict:
    return {"nodes": ["n1", "n2", "n3"], "ssh": {"dummy": True},
            "net": P["net"].noop(), "store": P["store"].Store(store), **kw}


def no_workers_left():
    return not [t for t in threading.enumerate()
                if t.name.startswith("jepsen-worker-")]


# ---------------------------------------------------------------------------
# One worker: the same history, files and results
# ---------------------------------------------------------------------------

def one_worker_test(P, store: Path, seed: int) -> dict:
    """An append test at concurrency 1 with the nemesis partitioning in
    its own phase, so the whole history is fixed by the seed. The txns
    are drawn before the run: a function generator draws again each
    time the interpreter polls it while its one worker is busy, and
    how often that happens is timing."""
    import random
    random.seed(seed)
    G = P["gen"]
    wl = P["append"].test(key_count=3, backend="cpu")
    draw = P["append"].AppendGen(key_count=3)
    txns = [draw() for _ in range(70)]
    return base(P, store, name="one-worker", concurrency=1,
                **{"start-time": START},
                client=list_client(P), nemesis=P["nemesis"].partition_halves(),
                generator=G.phases(
                    G.clients(txns[:60]),
                    G.nemesis(G.once({"type": "info", "f": "start"})),
                    G.clients(txns[60:]),
                    G.nemesis(G.once({"type": "info", "f": "stop"}))),
                checker=P["checker"].compose({
                    "elle": wl["checker"], "stats": P["checker"].stats(),
                    "exceptions": P["checker"].unhandled_exceptions()}))


def run_dir_files(d: Path) -> dict:
    """Every file of a run dir (and its links), times removed from the
    history and the timing files reduced to their names."""
    out = {}
    for p in sorted(d.rglob("*")):
        rel = str(p.relative_to(d))
        if p.is_symlink():
            out[rel] = ("link", p.readlink())
        elif p.name in ("trace.json", "metrics.json"):
            out[rel] = "timing"
        elif p.name == "history.jsonl":
            out[rel] = [{k: v for k, v in json.loads(ln).items()
                         if k != "time"}
                        for ln in p.read_text().splitlines()]
        elif p.name == "history.edn":
            out[rel] = re.sub(rb":time \d+", b":time T", p.read_bytes())
        elif p.is_file():
            out[rel] = p.read_bytes()
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_one_worker_run_equals_the_references(seed, tmp_path, reference_env):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        test = P["core"].run(one_worker_test(P, tmp_path / name, seed))
        got[name] = (test, run_dir_files(tmp_path / name))
    (rt, rfiles), (pt, pfiles) = got["ref"], got["port"]
    def strip(h):
        return [{k: v for k, v in o.items() if k != "time"} for o in h]
    assert strip(pt["history"]) == strip(rt["history"])
    assert len(pt["history"]) == 2 * 72
    assert json.dumps(port_store._stringify(pt["results"]),
                      sort_keys=True) == json.dumps(
        ref_store._stringify(rt["results"]), sort_keys=True)
    assert pfiles == rfiles
    run = f"one-worker/{START}/"
    assert {run + f for f in ("history.edn", "history.jsonl", "test.json",
                              "results.json", "results.edn")} <= set(pfiles)
    assert pt["results"]["valid?"] is True
    assert no_workers_left()


def crashing_client(P, every: int):
    """A register client whose every `every`-th op raises: the
    interpreter records it as :info and moves the thread to a fresh
    process with a fresh client."""
    count = [0]
    lock = threading.Lock()

    class Crashy(P["client"].Client):
        def invoke(self, test, op):
            with lock:
                count[0] += 1
                n = count[0]
            if n % every == 0:
                raise ConnectionResetError(f"lost op {n}")
            return {**op, "type": "ok"}

    return Crashy()


def test_one_worker_crashes_and_process_remap_equal_the_references(
        tmp_path, reference_env):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        G = P["gen"]
        test = P["core"].run(base(
            P, tmp_path / name, name="crashy", concurrency=1,
            **{"start-time": START}, client=crashing_client(P, 4),
            generator=G.clients(G.limit(
                20, [{"f": "write", "value": v} for v in range(30)])),
            checker=P["checker"].stats()))
        got[name] = [{k: v for k, v in o.items() if k != "time"}
                     for o in test["history"]]
    assert got["port"] == got["ref"]
    infos = [o for o in got["port"] if o["type"] == "info"]
    assert len(infos) == 5 and infos[0]["error"] == "indeterminate: lost op 4"
    assert sorted({o["process"] for o in got["port"]}) == [0, 1, 2, 3, 4]


def test_drain_interrupts_a_nemesis_sleep(tmp_path):
    """Once the generator is exhausted the interpreter wakes a worker
    sleeping on a long nemesis sleep, so the run ends with its clients,
    not 60 s later."""
    import time
    G = port_gen
    t0 = time.monotonic()
    test = port_core.run(base(
        PORT, tmp_path, name="drain", concurrency=2,
        client=list_client(PORT),
        generator=G.any_gen(
            G.clients(G.limit(10, port_append.generator())),
            G.nemesis(G.sleep(60))),
        checker=port_checker.stats()))
    assert time.monotonic() - t0 < 30
    assert sum(o["type"] == "invoke" for o in test["history"]) == 10
    assert no_workers_left()


def test_save_1_writes_the_references_files(tmp_path):
    """save_1 before analysis: test.json and the history, byte for byte,
    and the links; save_2 leaves the history as save_1 wrote it."""
    hist = [{"type": "invoke", "f": "txn", "process": i % 3, "time": i,
             "index": i, "value": [["append", i % 4, i], ["r", 0, None]]}
            for i in range(40)]
    for name, S in (("ref", ref_store), ("port", port_store)):
        t = {"name": "s1", "start-time": START, "history": hist,
             "nodes": ["n1"], "concurrency": 2}
        S.Store(tmp_path / name).save_1(t)
    assert run_dir_files(tmp_path / "port") == run_dir_files(tmp_path / "ref")
    d = tmp_path / "port" / "s1" / START
    before = (d / "history.jsonl").read_bytes()
    port_store.Store(tmp_path / "port").save_2(
        {"name": "s1", "start-time": START, "history": hist,
         "results": {"valid?": True}})
    assert (d / "history.jsonl").read_bytes() == before


def test_long_history_renders_in_chunks_to_the_same_bytes(tmp_path,
                                                         monkeypatch):
    hist = [{"type": "ok", "f": "read", "process": 0, "value": i,
             "index": i} for i in range(50)]
    for threshold, where in ((10_000, "whole"), (7, "chunked")):
        monkeypatch.setattr(port_store, "PARALLEL_WRITE_THRESHOLD",
                            threshold)
        port_store.Store(tmp_path / where).write_history(
            {"name": "h", "start-time": START, "history": hist})
    for f in ("history.edn", "history.jsonl"):
        assert (tmp_path / "whole" / "h" / START / f).read_bytes() == \
            (tmp_path / "chunked" / "h" / START / f).read_bytes()


# ---------------------------------------------------------------------------
# Threaded runs: the reference's analyze agrees with the port's verdict
# ---------------------------------------------------------------------------

def threaded_test(P, kind: str, store: Path, device=None) -> dict:
    G = P["gen"]
    dev = {} if P is REF else {"device": device or "cpu"}
    if kind in ("append", "append-stale"):
        wl = P["append"].test(key_count=4, **dev)
        return base(P, store, name=kind, concurrency=5,
                    client=list_client(P, 7 if kind == "append-stale"
                                       else 0),
                    generator=G.limit(300, wl["generator"]),
                    checker=wl["checker"])
    if kind == "wr":
        wl = P["wr"].test(key_count=4, seed=5, **dev)
        return base(P, store, name=kind, concurrency=5,
                    client=wr_client(P),
                    generator=G.clients(G.limit(300, wl["generator"])),
                    checker=wl["checker"])
    if kind == "register":
        wl = P["register"].test(threads_per_key=2, key_count=4,
                                ops_per_key=20, **dev)
        return base(P, store, name=kind, concurrency=4,
                    client=keyed_register_client(P),
                    generator=wl["generator"], checker=wl["checker"])
    assert kind == "bank"
    accounts = list(range(4))
    wl = P["bank"].test(accounts=accounts, plot=False)
    return base(P, store, name=kind, concurrency=4,
                client=bank_client(P, accounts),
                generator=G.limit(200, wl["generator"]),
                checker=wl["checker"],
                **{k: wl[k] for k in ("accounts", "total-amount")})


def verdict(res: dict) -> tuple:
    return (res.get("valid?"), res.get("anomaly-types"),
            res.get("failures"), res.get("bad-read-count"))


@pytest.mark.parametrize("kind", ["append", "append-stale", "wr",
                                  "register", "bank"])
def test_threaded_run_verdict_equals_the_references_analysis(
        kind, tmp_path, reference_env, monkeypatch, capsys):
    """The port's threaded run, stored, then analyzed by the reference's
    CLI (its own checker for the workload) on a copy of the store."""
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "cpu")
    test = port_core.run(threaded_test(PORT, kind, tmp_path / "port"))
    assert no_workers_left()
    port_res = test["results"]
    if kind == "append-stale":
        assert port_res["valid?"] is False
    elif kind != "register":
        assert port_res["valid?"] is True
    run = test["store"].test_dir(test)
    shutil.copytree(tmp_path / "port", tmp_path / "ref", symlinks=True)
    ref_run = tmp_path / "ref" / run.relative_to(tmp_path / "port")
    ref_check = threaded_test(REF, kind, tmp_path / "unused")["checker"]
    rc = ref_cli.run_cli(lambda t, a: {**t, "checker": ref_check},
                         argv=["analyze", str(ref_run), "--store",
                               str(tmp_path / "ref")])
    ref_res = json.loads((ref_run / "results.json").read_text())
    assert verdict(port_res) == verdict(ref_res)
    assert rc == cli.validity_exit_code(port_res)
    if kind == "register":
        assert {str(k): r["valid?"]
                for k, r in port_res["results"].items()} == \
            {k: r["valid?"] for k, r in ref_res["results"].items()}


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def cli_test_fn(P, kind: str):
    """A one-worker append test over txns drawn before the run (see
    one_worker_test), so its verdict is fixed."""
    def test_fn(t, args):
        import random
        random.seed(3)
        dev = {} if P is REF else {"device": "cpu"}
        wl = P["append"].test(key_count=3, backend="cpu", **dev)
        draw = P["append"].AppendGen(key_count=3)
        return {**t, "name": kind, "net": P["net"].noop(),
                "client": list_client(P, 5 if kind == "stale" else 0),
                "generator": P["gen"].clients([draw() for _ in range(40)]),
                "checker": wl["checker"]}
    return test_fn


def crashing_test(P):
    class Broken(P["db"].DB):
        def setup(self, test, node):
            raise RuntimeError(f"cannot install on {node}")
    return {"name": "crash", "db": Broken(), "nodes": ["n1"]}


def cli_lines(out: str, store: Path) -> list:
    return [json.loads(TIMESTAMP.sub(b"<t>", ln.replace(
                str(store).encode(), b"<store>")).decode())
            for ln in out.encode().splitlines() if ln.startswith(b"{")]


@pytest.mark.parametrize("case", ["valid", "stale", "count-3", "all",
                                  "all-valid"])
def test_test_commands_match_the_references(case, tmp_path, reference_env,
                                            capsys):
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        store = tmp_path / name
        argv = ["--dummy", "--store", str(store), "--concurrency", "1"]
        if case in ("valid", "stale"):
            rc = P["cli"].run_cli(cli_test_fn(P, case),
                                  argv=["test", *argv])
        elif case == "count-3":
            rc = P["cli"].run_cli(cli_test_fn(P, "valid"),
                                  argv=["test", "--test-count", "3", *argv])
        else:
            def tests_fn(t, args, P=P):
                fns = [cli_test_fn(P, "valid"), cli_test_fn(P, "stale")]
                tests = [fn(dict(t), args) for fn in fns]
                if case == "all":
                    tests.insert(1, {**t, **crashing_test(P)})
                return tests
            rc = P["cli"].run_cli(cli_test_fn(P, "valid"),
                                  argv=["test-all", *argv],
                                  tests_fn=tests_fn)
        got[name] = (rc, cli_lines(capsys.readouterr().out, store))
    assert got["port"] == got["ref"]
    rc, lines = got["port"]
    want = {"valid": (0, 1), "stale": (1, 1), "count-3": (0, 3),
            "all": (255, 3), "all-valid": (1, 2)}[case]
    assert (rc, len(lines)) == want
    assert no_workers_left()


def test_noop_test_runs_like_the_references(tmp_path, reference_env,
                                            capsys):
    got = {}
    for name, main in (("ref", lambda argv: ref_cli.run_cli(
            lambda t, a: t, argv=argv)), ("port", cli.main)):
        store = tmp_path / name
        rc = main(["test", "--dummy", "--store", str(store)])
        got[name] = (rc, cli_lines(capsys.readouterr().out, store))
    assert got["port"] == got["ref"] and got["port"][0] == 0


def stored_history_and_no_verdict(store: Path, name: str) -> None:
    (run,) = [p for p in (store / name).iterdir() if not p.is_symlink()]
    assert (run / "history.jsonl").stat().st_size > 0
    assert (run / "test.json").is_file()
    assert not (run / "results.json").exists()


def test_default_checker_without_a_card_exits_255(tmp_path, monkeypatch,
                                                  capsys):
    """A workload's checker built without a device is the device path:
    no card, DeviceUnavailable, exit 255, the history stored by
    save_1 and no verdict."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_fn(t, args):
        wl = port_append.test()
        return {**t, "name": "nocard", "client": list_client(PORT),
                "generator": port_gen.limit(20, wl["generator"]),
                "checker": wl["checker"]}
    rc = cli.run_cli(test_fn, argv=["test", "--dummy", "--store",
                                    str(tmp_path)])
    assert rc == 255
    assert "no CUDA device is available" in capsys.readouterr().err
    stored_history_and_no_verdict(tmp_path, "nocard")
    with pytest.raises(Exception) as e:
        port_core.run({**test_fn({"ssh": {"dummy": True},
                                  "store": port_store.Store(tmp_path)},
                                 None), "name": "nocard-run"})
    assert type(e.value).__name__ == "DeviceUnavailable"


@pytest.mark.parametrize("exc", [
    _build.KernelBuildError("nvcc failed building closure_square"),
    _build.KernelLaunchError("closure_square launch failed"),
], ids=["build", "launch"])
def test_kernel_failure_in_the_analysis_exits_255(exc, tmp_path, capsys):
    def f(test, history, opts):
        raise exc

    def test_fn(t, args):
        return {**t, "name": "kfail", "client": list_client(PORT),
                "generator": port_gen.limit(
                    10, port_append.generator()),
                "checker": port_checker.compose({
                    "stats": port_checker.stats(),
                    "kernel": port_checker.FnChecker(f)})}
    for command in ("test", "test-all"):
        rc = cli.run_cli(test_fn, argv=[command, "--dummy", "--store",
                                        str(tmp_path / command)])
        assert rc == 255
        stored_history_and_no_verdict(tmp_path / command, "kfail")
    assert no_workers_left()

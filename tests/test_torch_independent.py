"""`independent.checker` of the port against the JAX package's, on an
etcd-shaped lifted CAS-register run (and a lifted list-append one):
the batch route (a sub-checker with `check_batch`: one device dispatch
for every key, per-key failure renders) and the fan-out route (a
`compose` of timeline and linearizable, one `check_safe` a key over a
bounded thread pool), the race inside it, the per-key isolation when
the batch raises — and the port's departure there: a kernel build
failure or a missing device raises instead of being checked key by
key.

Both packages run on the same store path in turn.

Tolerance: results JSON-normalised (each package's
`store._stringify`, then `json.dumps`) and exactly equal; every per-key
file (`independent/<k>/results.edn`, `history.edn`, `linear.svg`,
`timeline.html`, `elle/*`) byte-identical."""

import json
import os
import shutil
import sys

import pytest

import jepsen_tpu.checker as ref_checker
import jepsen_tpu.checker.elle as ref_elle
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.store as ref_store
import jepsen_tpu_torch.checker as port_checker
import jepsen_tpu_torch.checker.elle as port_elle
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.store as port_store
from jepsen_tpu_torch import _build
from jepsen_tpu_torch.checker.elle import synth as esynth
from jepsen_tpu_torch.checker.knossos import synth as ksynth
from jepsen_tpu_torch.devices import DeviceUnavailable
from test_torch_cli import reference_env  # noqa: F401

PKGS = {"ref": (ref_checker, ref_ind, ref_store, ref_elle, {}),
        "port": (port_checker, port_ind, port_store, port_elle,
                 {"device": "cpu"})}
KEYS = 6


@pytest.fixture(scope="module")
def register_run(tmp_path_factory) -> list[dict]:
    """One lifted CAS-register run, key 0 corrupt, as stored."""
    base = tmp_path_factory.mktemp("reg")
    (d,) = ksynth.write_register_run_store(base, runs=1, ops=30 * KEYS,
                                           keys=KEYS, bad_every=1)
    return [json.loads(ln) for ln in
            (d / "history.jsonl").read_text().splitlines()]


def append_run(pkg: str) -> list[dict]:
    """A lifted list-append run: key 1's transactions carry a G1c."""
    ind = PKGS[pkg][1]
    out = []
    for k in range(3):
        h = esynth.synth_append_history(T=20, K=4, seed=k, g1c=k == 1)
        out += [{**o, "process": o["process"] + 10 * k,
                 "value": ind.Tuple(k, o["value"])} for o in h]
    return ind.relift_history(out)


def norm(res, pkg: str) -> str:
    return json.dumps(PKGS[pkg][2]._stringify(res), sort_keys=True)


def files(store) -> dict:
    return {str(p.relative_to(store)): p.read_bytes()
            for p in sorted(store.rglob("*")) if p.is_file()}


def in_turn(tmp_path, make, history) -> dict:
    """make(pkg) -> checker, run on `history(pkg)` in a store at one
    path, each package in turn; {pkg: (normalised result, files)}."""
    got = {}
    for pkg in PKGS:
        base = tmp_path / "store"
        test = {"name": "ind", "start-time": "run-1",
                "store": PKGS[pkg][2].Store(base)}
        res = make(pkg).check(test, history(pkg), {})
        got[pkg] = (norm(res, pkg), files(base))
        shutil.rmtree(base, ignore_errors=True)
    return got


def assert_same(got: dict) -> None:
    assert got["port"][0] == got["ref"][0]
    assert sorted(got["port"][1]) == sorted(got["ref"][1])
    for k, v in got["ref"][1].items():
        assert got["port"][1][k] == v, k


def lifted(register_run):
    return lambda pkg: PKGS[pkg][1].relift_history(register_run)


def linear(pkg: str, backend: str = "tpu"):
    c, _ind, _st, _elle, dev = PKGS[pkg]
    return c.linearizable(backend=backend, **dev)


ROUTES = {
    "batch": lambda pkg: PKGS[pkg][1].checker(linear(pkg)),
    "fan-out": lambda pkg: PKGS[pkg][1].checker(PKGS[pkg][0].compose({
        "timeline": PKGS[pkg][0].timeline_checker(),
        "linear": linear(pkg)})),
    "race": lambda pkg: PKGS[pkg][1].checker(linear(pkg, "race")),
    "cpu": lambda pkg: PKGS[pkg][1].checker(linear(pkg, "cpu")),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_register_routes_match_reference(route, register_run, tmp_path,
                                         reference_env):  # noqa: F811
    got = in_turn(tmp_path, ROUTES[route], lifted(register_run))
    assert_same(got)
    res = json.loads(got["port"][0])
    assert res["valid?"] is False and res["failures"] == [0]
    names = got["port"][1]
    for k in range(KEYS):
        for f in ("results.edn", "history.edn") + (
                ("timeline.html",) if route == "fan-out" else ()):
            assert f"ind/run-1/independent/{k}/{f}" in names
    assert [n for n in names if n.endswith("linear.svg")] == \
        ["ind/run-1/independent/0/linear.svg"]
    for t in list(port_checker.Linearizable._race_threads):
        t.join(timeout=60)


def test_fan_out_verdicts_equal_the_batch_route(register_run, tmp_path,
                                                monkeypatch):
    """More fan-out threads than cores, switching every microsecond:
    every key's verdict equals the batch route's."""
    monkeypatch.setattr(os, "cpu_count", lambda: 16)
    hist = port_ind.relift_history(register_run)
    batch = ROUTES["batch"]("port").check({}, hist, {})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            fan = ROUTES["fan-out"]("port").check({}, hist, {})
            assert {k: r["linear"] for k, r in fan["results"].items()} \
                == batch["results"]
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("backend", ["tpu", "cpu"],
                         ids=["device-path", "host-oracle"])
def test_append_under_independent_matches_reference(backend, tmp_path,
                                                    reference_env):  # noqa: F811
    """The batch route of an Elle sub-checker: one bucketed dispatch,
    then the failing key's elle/ artifacts from `render_failure`."""
    def make(pkg):
        _c, ind, _st, elle, dev = PKGS[pkg]
        return ind.checker(elle.append_checker(backend=backend, **dev))
    got = in_turn(tmp_path, make, append_run)
    assert_same(got)
    assert json.loads(got["port"][0])["failures"] == [1]
    assert "ind/run-1/independent/1/elle/G1c.txt" in got["port"][1]


def failing_batch(pkg: str, exc):
    """A linearizable checker whose batch of many histories raises
    `exc` (one history alone goes through)."""
    c = linear(pkg)
    one = c.check_batch

    def check_batch(test, histories, opts, **kw):
        if len(histories) > 1:
            raise exc
        return one(test, histories, opts, **kw)
    c.check_batch = check_batch
    return c


def test_batch_failure_checks_each_key_alone(register_run, tmp_path,
                                             reference_env):  # noqa: F811
    got = in_turn(tmp_path, lambda pkg: PKGS[pkg][1].checker(
        failing_batch(pkg, ValueError("malformed"))), lifted(register_run))
    assert_same(got)
    assert json.loads(got["port"][0])["failures"] == [0]


@pytest.mark.parametrize("exc", [_build.KernelBuildError("nvcc failed"),
                                 DeviceUnavailable("no CUDA device")],
                         ids=lambda e: type(e).__name__)
def test_batch_kernel_failure_raises(exc, register_run, tmp_path):
    """The departure: no per-key re-check of what is no key's fault,
    and no verdict or per-key file written."""
    store = port_store.Store(tmp_path / "store")
    test = {"name": "ind", "start-time": "run-1", "store": store}
    c = port_ind.checker(failing_batch("port", exc))
    with pytest.raises(type(exc)):
        c.check(test, port_ind.relift_history(register_run), {})
    with pytest.raises(type(exc)):
        port_checker.check_safe(c, test,
                                port_ind.relift_history(register_run), {})
    assert not (tmp_path / "store").exists()

"""The port's single-run Elle checkers against the JAX package's:
`elle.append_checker` and `elle.wr.rw_register_checker`, in `check`
(with the elle/ artifacts in a store) and `check_batch`, under the
device path (the port on `device="cpu"`, its plain versions, against
the reference's device path on CPU XLA) and the host oracle, and with
the device's flags diverging from the host pass both ways
(`artifacts.device_host_refine`).

Each package runs on the same store path in turn, so the artifact
paths a verdict records (`elle-dir`) are the same strings.

Tolerance: results JSON-normalised (each package's
`store._stringify`, then `json.dumps`) and exactly equal; every file the
checks write byte-identical."""

import json
import shutil

import pytest

import jepsen_tpu.checker.elle as ref_elle
import jepsen_tpu.checker.elle.artifacts as ref_artifacts
import jepsen_tpu.checker.elle.wr as ref_wr
import jepsen_tpu.parallel as ref_parallel
import jepsen_tpu.store as ref_store
import jepsen_tpu_torch.checker.elle as port_elle
import jepsen_tpu_torch.checker.elle.artifacts as port_artifacts
import jepsen_tpu_torch.checker.elle.wr as port_wr
import jepsen_tpu_torch.parallel as port_parallel
import jepsen_tpu_torch.store as port_store
from jepsen_tpu_torch.checker.elle import closure_square as cs
from jepsen_tpu_torch.checker.elle import synth
from test_torch_cli import reference_env  # noqa: F401

PKGS = {"ref": (ref_elle, ref_wr, ref_store, {}),
        "port": (port_elle, port_wr, port_store, {"device": "cpu"})}

APPEND = {"valid": synth.synth_append_history(T=40, K=5, seed=1),
          "g1c": synth.synth_append_history(T=40, K=5, seed=2, g1c=True)}
WR = {"valid": synth.wr_run_ops(T=40, K=5, seed=1),
      "skew": synth.wr_run_ops(T=40, K=5, seed=2, write_skew=True)}


def make(pkg: str, kind: str, backend: str, **kw):
    elle, wr, _st, dev = PKGS[pkg]
    if kind == "append":
        return elle.append_checker(backend=backend, **kw, **dev)
    return wr.rw_register_checker(backend=backend, **kw, **dev)


def norm(res, pkg: str) -> str:
    return json.dumps(PKGS[pkg][2]._stringify(res), sort_keys=True)


def files(store) -> dict:
    return {str(p.relative_to(store)): p.read_bytes()
            for p in sorted(store.rglob("*")) if p.is_file()}


def in_turn(tmp_path, fn) -> dict:
    """fn(pkg, test) for each package on the same store path; returns
    {pkg: (normalised result, files written)}."""
    got = {}
    for pkg in PKGS:
        base = tmp_path / "store"
        test = {"name": "elle", "start-time": "run-1",
                "store": PKGS[pkg][2].Store(base)}
        res = fn(pkg, test)
        got[pkg] = (norm(res, pkg), files(base))
        shutil.rmtree(base, ignore_errors=True)
    return got


def assert_same(got: dict) -> None:
    assert got["port"][0] == got["ref"][0]
    assert sorted(got["port"][1]) == sorted(got["ref"][1])
    for k, v in got["ref"][1].items():
        assert got["port"][1][k] == v, k


CASES = [("append", "valid"), ("append", "g1c"), ("wr", "valid"),
         ("wr", "skew")]


def history(kind: str, name: str) -> list[dict]:
    return (APPEND if kind == "append" else WR)[name]


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("kind,name", CASES)
def test_check_matches_reference(kind, name, backend, tmp_path,
                                 reference_env):  # noqa: F811
    h = history(kind, name)
    got = in_turn(tmp_path, lambda pkg, t: make(pkg, kind, backend)
                  .check(t, h, {}))
    assert_same(got)
    res = json.loads(got["port"][0])
    assert res["valid?"] is (name == "valid")
    if name != "valid":
        assert got["port"][1], "an invalid check writes its elle/ files"
        want = {"g1c": "G1c", "skew": "G2-item"}[name]
        assert want in res["anomaly-types"]
        assert f"run-1/elle/{want}.txt" in "\n".join(got["port"][1])


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("kind", ["append", "wr"])
def test_check_batch_matches_reference(kind, backend,
                                       reference_env):  # noqa: F811
    hs = [history(k, n) for k, n in CASES if k == kind] * 2
    want = make("ref", kind, backend).check_batch({}, hs, {})
    got = make("port", kind, backend).check_batch({}, hs, {})
    assert [norm(r, "port") for r in got] == [norm(r, "ref") for r in want]
    assert [r["valid?"] for r in got] == [True, False] * 2


#: Fake device flags: one the host pass cannot reproduce (device-only),
#: and one in place of what the host finds (both directions at once).
DIVERGE = {"device-only": ("valid", {"G0": True}),
           "both-ways": ("bad", {"G-single": True})}


def fake_flags(monkeypatch, pkg: str, flags: dict) -> None:
    """The device path of `pkg` returns `flags` for every history."""
    elle, wr, _st, _dev = PKGS[pkg]
    par = ref_parallel if pkg == "ref" else port_parallel
    monkeypatch.setattr(elle, "cycle_anomalies_tpu",
                        lambda enc, **kw: dict(flags))
    monkeypatch.setattr(wr, "cycle_anomalies_tpu",
                        lambda enc, **kw: dict(flags))
    monkeypatch.setattr(par, "check_bucketed",
                        lambda encs, *a, **kw: [dict(flags) for _ in encs])
    kern = __import__(f"{elle.__name__}.kernels", fromlist=["_"])
    monkeypatch.setattr(kern, "check_edge_batch_bucketed",
                        lambda eds, *a, **kw: [dict(flags) for _ in eds])


@pytest.mark.parametrize("way", list(DIVERGE))
@pytest.mark.parametrize("kind", ["append", "wr"])
def test_device_host_divergence_matches_reference(kind, way, tmp_path,
                                                  monkeypatch):
    name, flags = DIVERGE[way]
    h = history(kind, name if name == "valid" else
                ("g1c" if kind == "append" else "skew"))
    for pkg in PKGS:
        fake_flags(monkeypatch, pkg, flags)

    got = in_turn(tmp_path, lambda pkg, t: make(pkg, kind, "tpu")
                  .check(t, h, {}))
    assert_same(got)
    div = json.loads(got["port"][0])["device-host-divergence"]
    assert div["device-only"] == sorted(flags)
    assert ("host-only" in div) is (way == "both-ways")
    batch = {pkg: [norm(r, pkg) for r in make(pkg, kind, "tpu")
                   .check_batch({}, [h], {})] for pkg in PKGS}
    assert batch["port"] == batch["ref"]
    assert "device-host-divergence" in batch["port"][0]


def test_device_host_refine_and_render_match_reference():
    enc = port_elle.encode_history(APPEND["g1c"])
    host = port_elle.cycle_anomalies_cpu(enc)
    for device in ({"G1c": True}, {"G0": True}, {"G1c": True, "G0": True},
                   {}):
        want = ref_artifacts.device_host_refine(device, lambda: host)
        got = port_artifacts.device_host_refine(device, lambda: host)
        assert got == want
        assert port_artifacts.render_anomaly("G1c", got[0].get(
            "G1c", True)) == ref_artifacts.render_anomaly(
                "G1c", want[0].get("G1c", True))


def test_quarantined_history_gets_its_unknown_verdict(monkeypatch):
    """check_batch turns the dispatcher's Quarantined sentinel into the
    quarantine verdict, as the reference does."""
    from jepsen_tpu import supervisor as ref_sv
    from jepsen_tpu_torch import supervisor as port_sv
    hs = [APPEND["valid"], APPEND["g1c"]]
    got = {}
    for pkg, par, sv in (("ref", ref_parallel, ref_sv),
                         ("port", port_parallel, port_sv)):
        monkeypatch.setattr(par, "check_bucketed", lambda encs, *a, sv=sv,
                            **kw: [sv.Quarantined("watchdog", "wedged"), {}])
        got[pkg] = [norm(r, pkg) for r in make(pkg, "append", "tpu")
                    .check_batch({}, hs, {})]
    assert got["port"] == got["ref"]
    assert json.loads(got["port"][0])["quarantined"] == "watchdog"


def test_plain_squaring_and_launch_log(tmp_path):
    """`square` replaces the kernel and `bucket_log` records each
    dispatch's enqueued launches, as the chip smoke reads them."""
    log: list = []
    calls = []

    def square(m, mT, active=None):
        calls.append(1)
        return cs.closure_square_ref(m, mT, active)
    c = port_elle.append_checker(backend="tpu", device="cpu", square=square,
                                 bucket_log=log)
    r = c.check({}, APPEND["g1c"], {})
    assert r["valid?"] is False
    (entry,) = log
    assert entry["histories"] == 1 and entry["t_pad"] == 128
    assert entry["launches"] == len(calls) > 0
    assert 0 < sum(entry["closure_rounds"]) <= entry["launches"]
    c.check_batch({}, [APPEND["valid"], APPEND["g1c"]], {})
    assert len(log) == 2 and log[1]["launches"] == len(calls) - \
        entry["launches"]

"""The port's simple checkers, its backend rules and its check_safe
against the JAX package's.

Every checker of `jepsen_tpu_torch.checker` that is host code (compose,
stats, unhandled_exceptions, set, set_full, queue, total_queue,
unique_ids, counter, concurrency_limit, noop, unbridled_optimism, the
timeline) gets the same seeded numpy-made histories as its
counterpart in `jepsen_tpu.checker`; `Linearizable` is held to the
reference under every backend and algorithm, and its linear.svg byte
for byte. Then what the port does differently, on purpose:
`devices.resolve_backend`'s `auto` is the device path (never the host
oracle for want of a card), `check_safe` raises a kernel build or launch
failure or a missing device instead of writing it as a verdict, and the
race raises a device error that comes before the CPU side has won.

Tolerance: results JSON-normalised (each package's
`store._stringify`, then `json.dumps`) and exactly equal; rendered files
byte-identical."""

import json
import threading
import time

import numpy as np
import pytest

import jepsen_tpu.checker as ref
import jepsen_tpu.checker.timeline as ref_timeline
import jepsen_tpu.store as ref_store
import jepsen_tpu_torch.checker as port
import jepsen_tpu_torch.checker.timeline as port_timeline
import jepsen_tpu_torch.store as port_store
from jepsen_tpu_torch import _build, devices
from jepsen_tpu_torch.checker.knossos import synth as ksynth
from jepsen_tpu_torch.devices import DeviceUnavailable
from test_torch_cli import reference_env  # noqa: F401


def norm(res, pkg) -> str:
    st = ref_store if pkg is ref else port_store
    return json.dumps(st._stringify(res), sort_keys=True)


def ops(rows) -> list[dict]:
    """(type, process, f, value[, extra]) rows as an indexed, timed
    history."""
    out = []
    for i, r in enumerate(rows):
        o = {"type": r[0], "process": r[1], "f": r[2], "value": r[3],
             "time": i * 1_000_000, "index": i}
        if len(r) > 4:
            o.update(r[4])
        out.append(o)
    return out


def set_history(seed: int, lose: bool) -> list[dict]:
    rng = np.random.RandomState(seed)
    rows = []
    n = 40
    for v in range(n):
        p = int(rng.randint(4))
        rows.append(("invoke", p, "add", v))
        rows.append((("ok", "ok", "fail", "info")[rng.randint(4)], p, "add",
                     v))
    acked = {r[3] for r in rows if r[0] == "ok"}
    final = sorted(acked | {v for v in range(n) if rng.rand() < 0.3})
    if lose:
        final = final[2:] + [n + 7]
    rows += [("invoke", 9, "read", None), ("ok", 9, "read", final)]
    return ops(rows)


def set_full_history(seed: int) -> list[dict]:
    """Adds and concurrent reads by several processes: some elements
    stable, some read late (stale), one lost, one read twice in a read."""
    rng = np.random.RandomState(seed)
    rows, present = [], []
    for v in range(12):
        p = int(rng.randint(3))
        rows += [("invoke", p, "add", v), ("ok", p, "add", v)]
        present.append(v)
        r = 3 + int(rng.randint(2))
        seen = [x for x in present if rng.rand() < 0.8 or x < v - 2]
        rows += [("invoke", r, "read", None), ("ok", r, "read", seen)]
    rows += [("invoke", 5, "read", None),
             ("ok", 5, "read", [x for x in present if x != 4] + [1])]
    return ops(rows)


def queue_history(seed: int, bad: bool) -> list[dict]:
    rng = np.random.RandomState(seed)
    rows, q = [], []
    for v in range(30):
        rows += [("invoke", 0, "enqueue", v),
                 (("ok", "ok", "info")[rng.randint(3)], 0, "enqueue", v)]
        q.append(v)
        if rng.rand() < 0.5 and q:
            x = q.pop(int(rng.randint(len(q))))
            rows += [("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", x)]
    if bad:
        rows += [("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 99),
                 ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 0)]
    rows += [("invoke", 2, "drain", None), ("ok", 2, "drain", q[:-2])]
    return ops(rows)


def unique_ids_history(seed: int) -> list[dict]:
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(50):
        p = int(rng.randint(5))
        rows += [("invoke", p, "generate", None),
                 (("ok", "ok", "ok", "fail")[rng.randint(4)], p, "generate",
                  int(rng.randint(45)))]
    return ops(rows)


def counter_history(seed: int, bad: bool) -> list[dict]:
    rng = np.random.RandomState(seed)
    rows, total = [], 0
    for _ in range(40):
        p = int(rng.randint(4))
        if rng.rand() < 0.6:
            d = int(rng.randint(-2, 5))
            rows += [("invoke", p, "add", d),
                     (("ok", "ok", "fail", "info")[rng.randint(4)], p, "add",
                      d)]
            if rows[-1][0] == "ok":
                total += d
        else:
            rows += [("invoke", p, "read", None),
                     ("ok", p, "read", total + (50 if bad else 0))]
    return ops(rows)


def mixed_history(seed: int) -> list[dict]:
    """Client ops of several fs with ok/fail/info completions, crashed
    ops carrying errors and exception maps, and nemesis ops."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(60):
        p = int(rng.randint(4))
        f = ("read", "write", "cas")[rng.randint(3)]
        t = ("ok", "ok", "fail", "info")[rng.randint(4)]
        extra = {}
        if t == "info":
            extra = ({"error": ["timeout", int(rng.randint(3))]}
                     if rng.rand() < 0.5 else
                     {"exception": {"class": ("SocketTimeout",
                                              "ConnectException")[
                         rng.randint(2)], "message": "boom"}})
        rows += [("invoke", p, f, i), (t, p, f, i, extra)]
        if i % 17 == 0:
            rows += [("info", "nemesis", "start", None),
                     ("info", "nemesis", "stop", None)]
    rows += [("invoke", 3, "scan", None), ("fail", 3, "scan", None)]
    return ops(rows)


SIMPLE = {
    "noop": (lambda c: c.noop(), mixed_history),
    "unbridled": (lambda c: c.unbridled_optimism(), mixed_history),
    "stats": (lambda c: c.stats(), mixed_history),
    "unhandled-exceptions": (lambda c: c.unhandled_exceptions(),
                             mixed_history),
    "set": (lambda c: c.set_checker(), lambda s: set_history(s, False)),
    "set-lost": (lambda c: c.set_checker(), lambda s: set_history(s, True)),
    "set-never-read": (lambda c: c.set_checker(),
                       lambda s: set_history(s, False)[:-2]),
    "set-full": (lambda c: c.set_full(), set_full_history),
    "set-full-linearizable": (lambda c: c.set_full(linearizable=True),
                              set_full_history),
    "queue": (lambda c: c.queue(), lambda s: queue_history(s, False)),
    "queue-bad": (lambda c: c.queue(), lambda s: queue_history(s, True)),
    "total-queue": (lambda c: c.total_queue(),
                    lambda s: queue_history(s, False)),
    "total-queue-bad": (lambda c: c.total_queue(),
                        lambda s: queue_history(s, True)),
    "unique-ids": (lambda c: c.unique_ids(), unique_ids_history),
    "counter": (lambda c: c.counter(), lambda s: counter_history(s, False)),
    "counter-bad": (lambda c: c.counter(), lambda s: counter_history(s, True)),
    "concurrency-limit": (lambda c: c.concurrency_limit(2, c.stats()),
                          mixed_history),
    "compose": (lambda c: c.compose({
        "stats": c.stats(), "exceptions": c.unhandled_exceptions(),
        "ids": c.unique_ids(), "limited": c.concurrency_limit(
            1, c.counter())}), mixed_history),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(SIMPLE))
def test_simple_checker_matches_reference(name, seed):
    make, hist = SIMPLE[name]
    h = hist(seed)
    want = ref.check_safe(make(ref), {}, h, {})
    got = port.check_safe(make(port), {}, h, {})
    assert norm(got, port) == norm(want, ref)


def test_simple_checkers_judge():
    """The cases above are not vacuous: each checker gives both
    verdicts where its history asks for them."""
    def v(name, seed=0):
        make, hist = SIMPLE[name]
        return port.check_safe(make(port), {}, hist(seed), {})["valid?"]
    assert v("set") is True and v("set-lost") is False
    assert v("set-never-read") == "unknown"
    assert v("queue") is True and v("queue-bad") is False
    assert v("total-queue-bad") is False
    assert v("counter") is True and v("counter-bad") is False
    assert {v("unique-ids", s) for s in range(3)} == {False}
    assert v("set-full") is False       # element 1 read twice in a read
    assert port.frequency_distribution([0, 0.5, 1], [3, 1, 2]) == \
        ref.frequency_distribution([0, 0.5, 1], [3, 1, 2])
    drains = queue_history(0, False)
    assert port.expand_queue_drain_ops(drains) == \
        ref.expand_queue_drain_ops(drains)


def test_timeline_matches_reference(tmp_path):
    h = mixed_history(3)
    test = {"name": "tl", "start-time": "run-1"}
    assert port_timeline.render_html(test, h) == \
        ref_timeline.render_html(test, h)
    for pkg, st in ((ref, ref_store), (port, port_store)):
        t = dict(test, store=st.Store(tmp_path / pkg.__name__))
        assert pkg.timeline_checker().check(
            t, h, {"subdirectory": ["independent", "0"]}) == {"valid?": True}
    a, b = (tmp_path / p.__name__ / "tl" / "run-1" / "independent" / "0"
            / "timeline.html" for p in (ref, port))
    assert a.read_bytes() == b.read_bytes()


# -- linearizability -------------------------------------------------------

def register_histories() -> list[list[dict]]:
    """Valid and corrupt concurrent CAS-register histories."""
    hs = ksynth.synth_register_batch(B=3, n_ops=40, n_procs=4,
                                     info_prob=0.05, seed=5)
    return hs + [ksynth.corrupt(h, seed=i) for i, h in enumerate(hs)]


@pytest.mark.parametrize("backend", ["tpu", "cpu", "race"])
@pytest.mark.parametrize("algorithm", ["competition", "wgl", "linear"])
def test_linearizable_matches_reference(backend, algorithm,
                                       reference_env):  # noqa: F811
    """Every backend and algorithm: the port (device path on the CPU)
    against the reference (its device path on CPU XLA for tpu; race
    resolves to its oracle on a CPU-only host, the port races its
    device path against its oracle)."""
    hs = register_histories()
    want = ref.linearizable(backend=backend, algorithm=algorithm) \
        .check_batch({}, hs, {})
    got = port.linearizable(backend=backend, algorithm=algorithm,
                            device="cpu").check_batch({}, hs, {})
    assert [norm(r, port) for r in got] == [norm(r, ref) for r in want]
    assert [r["valid?"] for r in got] == [True] * 3 + [False] * 3
    for t in list(port.Linearizable._race_threads):
        t.join(timeout=60)
        assert not t.is_alive()


def test_linearizable_check_renders_linear_svg(tmp_path,
                                               reference_env):  # noqa: F811
    h = register_histories()[3]
    for pkg, st, kw in ((ref, ref_store, {}),
                        (port, port_store, {"device": "cpu"})):
        t = {"name": "lin", "start-time": "run-1",
             "store": st.Store(tmp_path / pkg.__name__)}
        r = pkg.linearizable(backend="tpu", **kw).check(t, h, {})
        assert r["valid?"] is False
    a, b = (tmp_path / p.__name__ / "lin" / "run-1" / "linear.svg"
            for p in (ref, port))
    assert a.read_bytes() == b.read_bytes()


def test_other_models_take_the_host_engine():
    """A model the device path does not implement runs on the WGL
    engine whatever the backend, as in the reference."""
    from jepsen_tpu.checker import models as rm
    from jepsen_tpu_torch.checker import models as pm
    h = ops([("invoke", 0, "acquire", None), ("ok", 0, "acquire", None),
             ("invoke", 1, "acquire", None), ("ok", 1, "acquire", None)])
    want = ref.linearizable(rm.mutex(), backend="tpu").check({}, h, {})
    got = port.linearizable(pm.mutex(), backend="tpu").check({}, h, {})
    assert norm(got, port) == norm(want, ref)
    assert got["valid?"] is False


# -- the backend rules -------------------------------------------------------

@pytest.mark.parametrize("backend,env,want", [
    ("tpu", None, "tpu"), ("cpu", None, "cpu"), ("cpu", "tpu", "cpu"),
    ("tpu", "cpu", "tpu"), ("auto", "cpu", "cpu"), ("auto", "tpu", "tpu"),
    ("race", "cpu", "cpu"), ("auto", "race", "tpu"),
    # the departure: auto is the device path with no card and no env
    ("auto", None, "tpu"), ("race", None, "tpu"), ("auto", "auto", "tpu"),
])
def test_resolve_backend(backend, env, want, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    if env is None:
        monkeypatch.delenv("JEPSEN_TPU_BACKEND", raising=False)
    else:
        monkeypatch.setenv("JEPSEN_TPU_BACKEND", env)
    assert devices.resolve_backend(backend) == want


def test_resolve_backend_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown backend"):
        devices.resolve_backend("gpu")


def test_default_checker_without_a_card_raises(monkeypatch):
    """No card and no backend asked for: the device path raises
    DeviceUnavailable. The reference would resolve to its host oracle
    here; the port runs the oracle only when asked for."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.delenv("JEPSEN_TPU_BACKEND", raising=False)
    h = register_histories()[0]
    with pytest.raises(DeviceUnavailable):
        port.linearizable().check({}, h, {})
    with pytest.raises(DeviceUnavailable):
        port.check_safe(port.linearizable(), {}, h, {})
    assert port.linearizable(backend="cpu").check({}, h, {})["valid?"] \
        is True
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "cpu")
    assert port.linearizable().check({}, h, {})["valid?"] is True


# -- check_safe: a kernel failure is no verdict -------------------------------

FATAL = [_build.KernelBuildError("nvcc failed"),
         _build.KernelLaunchError("launch failed"),
         DeviceUnavailable("no CUDA device"),
         RuntimeError("CUDA error: an illegal memory access")]


def raising(e):
    def f(test, history, opts):
        raise e
    return port.FnChecker(f)


@pytest.mark.parametrize("exc", FATAL, ids=lambda e: type(e).__name__)
def test_check_safe_reraises_what_must_end_the_run(exc):
    with pytest.raises(type(exc)):
        port.check_safe(raising(exc), {}, [], {})
    with pytest.raises(type(exc)):
        port.check_safe(port.compose({"ok": port.stats(),
                                      "kernel": raising(exc)}), {}, [], {})


def test_check_safe_keeps_other_failures_as_unknown():
    """Anything else is the reference's unknown verdict, in compose
    too."""
    r = port.check_safe(raising(ValueError("bad history")), {}, [], {})
    w = ref.check_safe(ref.FnChecker(lambda *a: 1 / 0), {}, [], {})
    assert r["valid?"] == w["valid?"] == "unknown"
    assert "ValueError: bad history" in r["error"]
    c = port.compose({"stats": port.stats(),
                      "bad": raising(ValueError("x"))})
    assert port.check_safe(c, {}, [], {})["valid?"] == "unknown"


# -- the race -----------------------------------------------------------------

def slow(f, s):
    def g(*a, **kw):
        time.sleep(s)
        return f(*a, **kw)
    return g


def join_race():
    for t in list(port.Linearizable._race_threads):
        t.join(timeout=60)
        assert not t.is_alive()


def test_race_raises_a_device_error_that_comes_first(monkeypatch):
    """The departure: the device side fails before the CPU side has
    won, and the race raises it instead of waiting for the CPU's
    answer."""
    c = port.linearizable(backend="race", device="cpu")
    monkeypatch.setattr(c, "_cpu", slow(c._cpu, 0.5))

    def fails(*a, **kw):
        raise _build.KernelLaunchError("launch failed")
    monkeypatch.setattr(c, "_device_batch", fails)
    with pytest.raises(_build.KernelLaunchError):
        c.check_batch({}, register_histories(), {})
    join_race()


def test_race_cpu_side_that_wins_first_answers(monkeypatch):
    hs = register_histories()
    c = port.linearizable(backend="race", device="cpu")

    def fails_late(*a, **kw):
        time.sleep(0.5)
        raise _build.KernelLaunchError("launch failed")
    monkeypatch.setattr(c, "_device_batch", fails_late)
    got = c.check_batch({}, hs, {})
    want = port.linearizable(backend="cpu").check_batch({}, hs, {})
    assert got == want
    # the losing device side's launch failure is not dropped: settling
    # the race raises it, once
    with pytest.raises(_build.KernelLaunchError):
        port.Linearizable.settle_races(timeout=60)
    assert not port.Linearizable._race_threads
    port.Linearizable.settle_races()


@pytest.mark.parametrize("device", ["agrees", "disagrees", "fails"])
def test_race_holds_its_losing_device_side(monkeypatch, device):
    """The CPU side answers first; the device side that ends after it
    is compared with that answer (`race_device_agree` or
    `race_device_disagree`), or its failure counted
    (`race_device_error`). A failure a verdict may carry (not a kernel
    or device one) is not raised by settle_races."""
    from jepsen_tpu_torch import trace
    tr = trace.fresh_run("race")
    hs = register_histories()
    c = port.linearizable(backend="race", device="cpu")
    real = c._device_batch

    def late(*a, **kw):
        time.sleep(0.5)
        if device == "fails":
            raise ValueError("a device-path fault")
        out = real(*a, **kw)
        if device == "disagrees":
            out[0] = {**out[0], "valid?": not out[0]["valid?"]}
        return out
    monkeypatch.setattr(c, "_device_batch", late)
    got = c.check_batch({}, hs, {})
    assert got == port.linearizable(backend="cpu").check_batch({}, hs, {})
    port.Linearizable.settle_races(timeout=60)
    counters = tr.metrics_dict()["counters"]
    assert counters.get("race_won_cpu") == 1
    want = {"agrees": "race_device_agree",
            "disagrees": "race_device_disagree",
            "fails": "race_device_error"}[device]
    assert {k: v for k, v in counters.items()
            if k.startswith("race_device")} == {want: 1}


@pytest.mark.parametrize("device_fails", [False, True])
def test_race_cpu_failure_leaves_the_answer_to_the_device(monkeypatch,
                                                          device_fails):
    hs = register_histories()
    c = port.linearizable(backend="race", device="cpu")

    def cpu_fails(*a, **kw):
        raise ValueError("oracle failed")
    monkeypatch.setattr(c, "_cpu", cpu_fails)
    if device_fails:
        def dev_fails(*a, **kw):
            time.sleep(0.2)
            raise DeviceUnavailable("no CUDA device")
        monkeypatch.setattr(c, "_device_batch", dev_fails)
        with pytest.raises(DeviceUnavailable):
            c.check_batch({}, hs, {})
    else:
        got = c.check_batch({}, hs, {})
        assert [r["valid?"] for r in got] == [True] * 3 + [False] * 3
    join_race()


def test_race_counts_its_winner(monkeypatch):
    from jepsen_tpu_torch import trace
    tr = trace.fresh_run("race")
    c = port.linearizable(backend="race", device="cpu")
    monkeypatch.setattr(c, "_cpu", slow(c._cpu, 1.0))
    c.check_batch({}, register_histories(), {})
    join_race()
    counters = tr.metrics_dict()["counters"]
    assert counters.get("race_won_device") == 1
    assert "race_won_cpu" not in counters


def test_race_threads_do_not_outlive_the_race_by_much(monkeypatch):
    """Both sides of a race end: the loser stops at a history boundary
    (the CPU side) or runs its course (the device side)."""
    c = port.linearizable(backend="race", device="cpu")
    c.check_batch({}, register_histories(), {})
    deadline = time.monotonic() + 60
    while port.Linearizable._race_threads and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not port.Linearizable._race_threads
    assert not any(t.name.startswith("linearizable-race")
                   for t in threading.enumerate())


# -- the history and util helpers the checkers share ----------------------

def test_history_and_util_helpers_match_reference():
    import jepsen_tpu.history as ref_h
    import jepsen_tpu.util as ref_util
    import jepsen_tpu_torch.history as port_h
    import jepsen_tpu_torch.util as port_util
    h = mixed_history(4)
    for f in ("invocations", "completions", "oks", "history_latencies",
              "nemesis_intervals"):
        assert getattr(port_h, f)(h) == getattr(ref_h, f)(h), f
    assert port_h.filter_f("cas", h) == ref_h.filter_f("cas", h)
    assert port_h.nemesis_intervals(h, {"start"}, {"stop"}) == \
        ref_h.nemesis_intervals(h, {"start"}, {"stop"})
    xs = list(np.random.RandomState(0).randint(0, 30, 25))
    assert port_util.integer_interval_set_str(xs) == \
        ref_util.integer_interval_set_str(xs)
    assert port_util.name_of(3) == ref_util.name_of(3) == "3"
    for pmap in (port_util.real_pmap, port_util.bounded_pmap):
        assert pmap(lambda x: x * x, range(20)) == [x * x for x in range(20)]
        with pytest.raises(ZeroDivisionError):
            pmap(lambda x: 1 // x, [3, 0, 2])

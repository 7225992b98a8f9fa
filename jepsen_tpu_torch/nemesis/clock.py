"""Clock faults: bumps, strobes, resets.

Counterpart of jepsen.nemesis.time (jepsen/src/jepsen/nemesis/time.clj):
ships the native C++ helpers (native/bump_time.cc, strobe_time.cc — our
re-implementations of the reference's resources/bump-time.c and
strobe-time.c) to each node, compiles them with the node's compiler
(time.clj:15-53), and drives them through nemesis ops:

  {:f :reset,  :value [nodes...]}          ntpdate back to true time
  {:f :bump,   :value {node: delta-ms}}    one-shot clock jumps
  {:f :strobe, :value {node: {...}}}       rapid clock flapping
  {:f :check-offsets}                      annotate clock offsets

The port's copy of `jepsen_tpu/nemesis/clock.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import logging
import os.path
import random

from .. import control
from ..control import util as cutil
from . import Nemesis

log = logging.getLogger(__name__)

BIN_DIR = "/opt/jepsen"
#: The port's own copies of the helper sources (`jepsen_tpu_torch/native/`)
NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")

HELPERS = ("bump_time", "strobe_time")


def install_helpers(test: dict, node: str) -> None:
    """Upload + compile the clock helpers on a node (time.clj:15-53)."""
    sess = control.current_session()
    su = sess.su()
    su.exec("mkdir", "-p", BIN_DIR)
    for name in HELPERS:
        src = os.path.join(NATIVE_DIR, f"{name}.cc")
        dest_src = f"{BIN_DIR}/{name}.cc"
        dest_bin = f"{BIN_DIR}/{name.replace('_', '-')}"
        sess.upload(src, "/tmp/" + os.path.basename(src))
        su.exec("mv", "/tmp/" + os.path.basename(src), dest_src)
        su.exec(control.Lit(
            f"g++ -O2 -o {dest_bin} {dest_src} 2>/dev/null || "
            f"gcc -O2 -x c++ -o {dest_bin} {dest_src} -lstdc++"))


def reset_time(test: dict, node: str) -> str:
    """Snap the clock back to true time (time.clj:72-76)."""
    return control.current_session().su().exec(
        control.Lit("ntpdate -p 1 -b pool.ntp.org || "
                    "ntpdate -p 1 -b time.google.com"))


def bump_time(test: dict, node: str, delta_ms: float) -> str:
    return control.current_session().su().exec(
        f"{BIN_DIR}/bump-time", delta_ms)


def strobe_time(test: dict, node: str, delta_ms: float, period_ms: float,
                duration_s: float) -> str:
    return control.current_session().su().exec(
        f"{BIN_DIR}/strobe-time", delta_ms, period_ms, duration_s)


def clock_offset(test: dict, node: str) -> float:
    """Node wall-clock offset from the control host, in seconds."""
    import time as _t
    remote = float(control.current_session().exec("date", "+%s.%N"))
    return remote - _t.time()


class ClockNemesis(Nemesis):
    """Drives reset/bump/strobe/check-offsets ops (time.clj:90-140)."""

    fs = frozenset({"reset", "bump", "strobe", "check-offsets"})

    def setup(self, test):
        control.on_nodes(test, install_helpers)
        control.on_nodes(test, reset_time)
        return self

    def invoke(self, test, op):
        f = op.get("f")
        v = op.get("value")
        if f == "reset":
            nodes = v or test.get("nodes", [])
            res = control.on_nodes(test, reset_time, list(nodes))
        elif f == "bump":
            res = control.on_nodes(
                test, lambda t, n: bump_time(t, n, v[n]), list(v))
        elif f == "strobe":
            res = control.on_nodes(
                test,
                lambda t, n: strobe_time(t, n, v[n]["delta"],
                                         v[n]["period"], v[n]["duration"]),
                list(v))
        elif f == "check-offsets":
            res = control.on_nodes(test, clock_offset)
            return {**op, "type": "info", "clock-offsets": dict(res)}
        else:
            raise ValueError(f"unknown clock op {op!r}")
        return {**op, "type": "info", "value": [f, dict(res)]}

    def teardown(self, test):
        try:
            control.on_nodes(test, reset_time)
        except Exception as e:
            log.warning("clock teardown failed: %s", e)


def clock_nemesis() -> Nemesis:
    return ClockNemesis()


# -- generators (time.clj:142-201) -----------------------------------------

def reset_gen(test=None, ctx=None):
    return {"type": "info", "f": "reset", "value": None}


def bump_gen(test, ctx):
    """Bump a random subset of nodes by ±2^2..2^18 ms (time.clj:155-172)."""
    nodes = list(test.get("nodes", []))
    random.shuffle(nodes)
    targets = nodes[: random.randint(1, max(1, len(nodes)))]
    delta = (2 ** random.randint(2, 18)) * random.choice([-1, 1])
    return {"type": "info", "f": "bump",
            "value": {n: delta for n in targets}}


def strobe_gen(test, ctx):
    """Strobe a random subset: delta ±2^2..2^18 ms, period 1-1024 ms,
    duration 0-32 s (time.clj:174-191)."""
    nodes = list(test.get("nodes", []))
    random.shuffle(nodes)
    targets = nodes[: random.randint(1, max(1, len(nodes)))]
    spec = {"delta": 2 ** random.randint(2, 18),
            "period": 2 ** random.randint(0, 10),
            "duration": random.randint(0, 32)}
    return {"type": "info", "f": "strobe", "value": {n: spec for n in targets}}


def clock_gen():
    """Mix of resets, bumps, strobes (time.clj:193-201)."""
    from .. import generator as gen
    return gen.mix([reset_gen, bump_gen, strobe_gen])


def set_time(t: float) -> str:
    """Set the current session's node clock to POSIX time t
    (nemesis.clj:313-316)."""
    return control.current_session().su().exec(
        "date", "+%s", "-s", f"@{int(t)}")


class ClockScrambler(Nemesis):
    """Randomizes every node's clock within a ±dt-second window on each
    invoke; teardown snaps them back to true time
    (nemesis.clj:318-333)."""

    fs = frozenset({"scramble"})

    def __init__(self, dt: float):
        self.dt = dt

    def invoke(self, test, op):
        import time as _time

        def scramble(t, node):
            return set_time(_time.time()
                            + random.randint(-int(self.dt), int(self.dt)))

        value = control.on_nodes(test, scramble)
        return {**op, "type": "info", "value": value}

    def teardown(self, test):
        import time as _time
        try:
            control.on_nodes(test,
                             lambda t, n: set_time(_time.time()))
        except Exception:
            log.warning("clock scrambler teardown failed", exc_info=True)


def clock_scrambler(dt: float) -> Nemesis:
    return ClockScrambler(dt)

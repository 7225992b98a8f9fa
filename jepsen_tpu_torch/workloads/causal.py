"""Causal-consistency workload: a causal order of register ops that must
appear to execute in issue order, with position links.

Counterpart of jepsen.tests.causal (jepsen/src/jepsen/tests/causal.clj):
a CausalRegister model steps through ok ops carrying ``value``,
``position`` and ``link`` fields; each op must link to the previously
seen position (or "init"), writes must produce the next counter value,
and reads must return the current value (CausalRegister
causal.clj:35-84). The canonical causal order per key is
[read-init, write 1, read, write 2, read] (causal.clj:119-145).

The port's copy of `jepsen_tpu/workloads/causal.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from typing import Any

from .. import generator as gen, independent
from ..checker import Checker


class Inconsistent:
    """Invalid model termination (causal.clj:17-32)."""

    def __init__(self, msg: str):
        self.msg = msg

    def step(self, op):
        return self


def is_inconsistent(m) -> bool:
    return isinstance(m, Inconsistent)


class CausalRegister:
    """value/counter/last-position state machine (causal.clj:35-84)."""

    def __init__(self, value: int = 0, counter: int = 0, last_pos=None):
        self.value = value
        self.counter = counter
        self.last_pos = last_pos

    def step(self, op: dict):
        c = self.counter + 1
        v = op.get("value")
        pos = op.get("position")
        link = op.get("link")
        if link not in ("init", self.last_pos):
            return Inconsistent(
                f"Cannot link {link} to last-seen position {self.last_pos}")
        f = op.get("f")
        if f == "write":
            if v == c:
                return CausalRegister(v, c, pos)
            return Inconsistent(
                f"expected value {c} attempting to write {v} instead")
        if f == "read-init":
            if self.counter == 0 and v not in (0, None):
                return Inconsistent(f"expected init value 0, read {v}")
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return Inconsistent(
                f"can't read {v} from register {self.value}")
        if f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return Inconsistent(
                f"can't read {v} from register {self.value}")
        return Inconsistent(f"unknown f {f!r}")


def causal_register() -> CausalRegister:
    return CausalRegister(0, 0, None)


class CausalChecker(Checker):
    """Steps the model through every ok op (check causal.clj:89-111)."""

    def __init__(self, m=None):
        self.model = m or causal_register()

    def check(self, test, history, opts):
        s = self.model
        for op in history:
            if op.get("type") != "ok":
                continue
            s = s.step(op)
            if is_inconsistent(s):
                return {"valid?": False, "error": s.msg}
        return {"valid?": True, "model": s.value}


def check(m=None) -> Checker:
    return CausalChecker(m)


# Generator ops (causal.clj:114-117)
def r(test=None, ctx=None):
    return {"type": "invoke", "f": "read"}


def ri(test=None, ctx=None):
    return {"type": "invoke", "f": "read-init"}


def cw1(test=None, ctx=None):
    return {"type": "invoke", "f": "write", "value": 1}


def cw2(test=None, ctx=None):
    return {"type": "invoke", "f": "write", "value": 2}


def test(time_limit: float = 60, keys=None) -> dict:
    """Workload package: per-key causal order [ri cw1 r cw2 r] behind
    independent keys, nemesis on a 10s start/stop cycle
    (causal.clj:119-145)."""
    # Bounded stand-in for the reference's infinite (range): the
    # concurrent generator materializes its key list.
    ks = keys if keys is not None else range(10_000)
    return {
        "checker": independent.checker(check(causal_register())),
        "generator": gen.time_limit(
            time_limit,
            gen.clients(
                gen.stagger(1, independent.concurrent_generator(
                    1, ks, lambda k: [gen.once(g)
                                      for g in (ri, cw1, r, cw2, r)])),
                gen.cycle([gen.sleep(10), {"type": "info", "f": "start"},
                           gen.sleep(10), {"type": "info", "f": "stop"}]))),
    }

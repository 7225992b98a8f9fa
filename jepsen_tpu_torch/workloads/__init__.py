"""L9: the workload library — partial test maps with generators+checkers.

Counterpart of jepsen.tests (jepsen/src/jepsen/tests.clj): `noop_test` is
the base test map (tests.clj:12-25), and the atom DB/client pair is the
in-process fake database used by integration tests (tests.clj:27-67) — a
compare-and-set register backed by a lock-protected cell with a 1 ms
sleep for real concurrency.

The port's copy of `jepsen_tpu/workloads/__init__.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import threading
import time

from .. import checker as jchecker
from .. import client as jclient
from .. import db as jdb


def noop_test() -> dict:
    """A valid no-op test skeleton (tests.clj:12-25)."""
    return {
        "name": "noop",
        "os": None,   # filled with noop by prepare_test
        "db": None,
        "client": None,
        "generator": None,
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "checker": jchecker.unbridled_optimism(),
        "ssh": {"dummy": True},
    }


class AtomRegister:
    """The shared in-process register (one per test run)."""

    def __init__(self, value=0):
        self.value = value
        self.lock = threading.Lock()

    def read(self):
        with self.lock:
            return self.value

    def write(self, v):
        with self.lock:
            self.value = v

    def cas(self, old, new) -> bool:
        with self.lock:
            if self.value == old:
                self.value = new
                return True
            return False


class AtomDB(jdb.DB):
    """Resets the shared register on setup (tests.clj:27-33)."""

    def __init__(self, register: AtomRegister):
        self.register = register

    def setup(self, test, node):
        self.register.write(0)

    def teardown(self, test, node):
        pass


class AtomClient(jclient.Client):
    """CAS register client against the in-process atom
    (tests.clj:34-67)."""

    def __init__(self, register: AtomRegister):
        self.register = register

    def open(self, test, node):
        return AtomClient(self.register)

    def invoke(self, test, op):
        time.sleep(0.001)  # real concurrency window
        f, v = op.get("f"), op.get("value")
        if f == "read":
            return {**op, "type": "ok", "value": self.register.read()}
        if f == "write":
            self.register.write(v)
            return {**op, "type": "ok"}
        if f == "cas":
            old, new = v
            ok = self.register.cas(old, new)
            return {**op, "type": "ok" if ok else "fail"}
        return {**op, "type": "fail", "error": f"unknown f {f!r}"}


def atom_fixtures():
    """(db, client) pair sharing one register."""
    reg = AtomRegister()
    return AtomDB(reg), AtomClient(reg)

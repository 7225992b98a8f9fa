"""Data-type models: pure state machines consistency checks step through.

The port's copy of `jepsen_tpu/checker/models.py`, unchanged: reprs and
equality are part of the verdicts the WGL search writes.

Counterpart of knossos.model (used by the reference's queue and
linearizable checkers; jepsen/src/jepsen/checker.clj:188-240). A model's
`step(op)` returns the next model state, or an `Inconsistent` describing why
the transition is illegal. Models must be hashable and comparable so the
linearizability search can deduplicate configurations.
"""

from __future__ import annotations

from typing import Any


class Inconsistent:
    __slots__ = ("msg",)

    def __init__(self, msg: str):
        self.msg = msg

    def __repr__(self) -> str:
        return f"Inconsistent({self.msg!r})"


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(m: Any) -> bool:
    return isinstance(m, Inconsistent)


class Model:
    """Base model. step returns the successor state or Inconsistent."""

    def step(self, op: dict) -> "Model | Inconsistent":
        raise NotImplementedError


class Register(Model):
    """A read/write register."""

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def step(self, op: dict) -> Model | Inconsistent:
        f, v = op.get("f"), op.get("value")
        if f == "write":
            return Register(v)
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"read {v!r}, but expected {self.value!r}")
        return inconsistent(f"unknown op f={f!r}")

    def __eq__(self, o):
        return isinstance(o, Register) and o.value == self.value

    def __hash__(self):
        return hash(("Register", self.value))

    def __repr__(self):
        return f"Register({self.value!r})"


class CASRegister(Model):
    """A register supporting read / write / cas [old new].

    The canonical model for etcd-style linearizable registers
    (knossos.model/cas-register; reference etcd suite client ops)."""

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def step(self, op: dict) -> Model | Inconsistent:
        f, v = op.get("f"), op.get("value")
        if f == "write":
            return CASRegister(v)
        if f == "cas":
            if v is None:
                return inconsistent("cas with nil value")
            old, new = v
            if old == self.value:
                return CASRegister(new)
            return inconsistent(f"can't CAS {self.value!r} from {old!r} to {new!r}")
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v!r} from register {self.value!r}")
        return inconsistent(f"unknown op f={f!r}")

    def __eq__(self, o):
        return isinstance(o, CASRegister) and o.value == self.value

    def __hash__(self):
        return hash(("CASRegister", self.value))

    def __repr__(self):
        return f"CASRegister({self.value!r})"


class Mutex(Model):
    """A lock: acquire / release."""

    __slots__ = ("locked",)

    def __init__(self, locked: bool = False):
        self.locked = locked

    def step(self, op: dict) -> Model | Inconsistent:
        f = op.get("f")
        if f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire a held lock")
            return Mutex(True)
        if f == "release":
            if not self.locked:
                return inconsistent("cannot release a free lock")
            return Mutex(False)
        return inconsistent(f"unknown op f={f!r}")

    def __eq__(self, o):
        return isinstance(o, Mutex) and o.locked == self.locked

    def __hash__(self):
        return hash(("Mutex", self.locked))

    def __repr__(self):
        return f"Mutex({'locked' if self.locked else 'free'})"


class UnorderedQueue(Model):
    """A queue where dequeues may come back in any order — used by the queue
    checker, which doesn't explore orderings (checker.clj:221-240)."""

    __slots__ = ("pending",)

    def __init__(self, pending: frozenset | None = None):
        # pending is a multiset encoded as frozenset of (value, copy#).
        self.pending = pending if pending is not None else frozenset()

    def _counts(self) -> dict:
        out: dict = {}
        for v, _ in self.pending:
            out[v] = out.get(v, 0) + 1
        return out

    def step(self, op: dict) -> Model | Inconsistent:
        f, v = op.get("f"), op.get("value")
        if f == "enqueue":
            n = self._counts().get(v, 0)
            return UnorderedQueue(self.pending | {(v, n)})
        if f == "dequeue":
            n = self._counts().get(v, 0)
            if n == 0:
                return inconsistent(f"can't dequeue {v!r} which was never enqueued")
            return UnorderedQueue(self.pending - {(v, n - 1)})
        return inconsistent(f"unknown op f={f!r}")

    def __eq__(self, o):
        return isinstance(o, UnorderedQueue) and o.pending == self.pending

    def __hash__(self):
        return hash(("UnorderedQueue", self.pending))

    def __repr__(self):
        return f"UnorderedQueue({sorted(self.pending)})"


class FIFOQueue(Model):
    """A single-consumer FIFO queue."""

    __slots__ = ("items",)

    def __init__(self, items: tuple = ()):
        self.items = items

    def step(self, op: dict) -> Model | Inconsistent:
        f, v = op.get("f"), op.get("value")
        if f == "enqueue":
            return FIFOQueue(self.items + (v,))
        if f == "dequeue":
            if not self.items:
                return inconsistent(f"can't dequeue {v!r} from empty queue")
            if self.items[0] != v:
                return inconsistent(
                    f"expected to dequeue {self.items[0]!r}, got {v!r}")
            return FIFOQueue(self.items[1:])
        return inconsistent(f"unknown op f={f!r}")

    def __eq__(self, o):
        return isinstance(o, FIFOQueue) and o.items == self.items

    def __hash__(self):
        return hash(("FIFOQueue", self.items))

    def __repr__(self):
        return f"FIFOQueue({list(self.items)})"


def cas_register(value: Any = None) -> CASRegister:
    return CASRegister(value)


def register(value: Any = None) -> Register:
    return Register(value)


def mutex() -> Mutex:
    return Mutex()


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()

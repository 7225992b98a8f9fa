"""L2: fault injection — the nemesis.

Counterpart of jepsen.nemesis (jepsen/src/jepsen/nemesis.clj): a Nemesis
has setup/invoke/teardown (nemesis.clj:10-15) and responds to :info ops
from the generator by breaking the system. Grudge functions compute who
stops talking to whom (nemesis.clj:121-226); `compose` routes ops to
children by :f (nemesis.clj:228-311).

The port's copy of `jepsen_tpu/nemesis/__init__.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import logging
import random
from typing import Callable, Iterable

from .. import control, net as jnet
from ..control import util as cutil
from ..util import majority, timeout_call

log = logging.getLogger(__name__)


class Nemesis:
    # fs this nemesis handles — used by compose routing (Reflection/fs,
    # nemesis.clj:17-20).
    fs: frozenset = frozenset()

    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass


class NoopNemesis(Nemesis):
    def invoke(self, test, op):
        return {**op, "type": "info"}


def noop() -> Nemesis:
    return NoopNemesis()


class Timeout(Nemesis):
    """Bounds a flaky nemesis's ops; timed-out ops get :value :timeout
    (nemesis.clj:105-119)."""

    def __init__(self, timeout_s: float, nemesis: Nemesis):
        self.timeout_s = timeout_s
        self.nemesis = nemesis
        self.fs = nemesis.fs

    def setup(self, test):
        self.nemesis = self.nemesis.setup(test)
        return self

    def invoke(self, test, op):
        return timeout_call(self.timeout_s,
                            lambda: self.nemesis.invoke(test, op),
                            default={**op, "type": "info",
                                     "value": "timeout"})

    def teardown(self, test):
        self.nemesis.teardown(test)


# ---------------------------------------------------------------------------
# Grudges: {node: set of nodes whose traffic it drops}
# ---------------------------------------------------------------------------

def bisect(coll: list) -> list[list]:
    """Split in half, smaller half first (nemesis.clj:121-125)."""
    mid = len(coll) // 2
    return [list(coll[:mid]), list(coll[mid:])]


def split_one(coll: list, loner=None) -> list[list]:
    """One node versus the rest (nemesis.clj:126-131)."""
    loner = loner if loner is not None else random.choice(list(coll))
    return [[loner], [x for x in coll if x != loner]]


def complete_grudge(components: Iterable[Iterable]) -> dict:
    """No node may talk outside its component (nemesis.clj:133-146)."""
    comps = [set(c) for c in components]
    universe = set().union(*comps) if comps else set()
    grudge = {}
    for comp in comps:
        for node in comp:
            grudge[node] = universe - comp
    return grudge


def bridge(nodes: list) -> dict:
    """Two halves with one bridge node seeing both (nemesis.clj:147-158)."""
    comps = bisect(list(nodes))
    b = comps[1][0]
    grudge = complete_grudge(comps)
    grudge.pop(b, None)
    return {node: snubbed - {b} for node, snubbed in grudge.items()}


def majorities_ring(nodes: list) -> dict:
    """Every node sees a majority, but no two see the same one
    (nemesis.clj:205-226)."""
    nodes = list(nodes)
    U = set(nodes)
    n = len(nodes)
    m = majority(n)
    ring = random.sample(nodes, n)
    grudge = {}
    for i in range(n):
        maj = [ring[(i + j) % n] for j in range(m)]
        holder = maj[len(maj) // 2]
        grudge[holder] = U - set(maj)
    return grudge


# ---------------------------------------------------------------------------
# Partitioners
# ---------------------------------------------------------------------------

class Partitioner(Nemesis):
    """:start cuts links per the grudge; :stop heals
    (nemesis.clj:160-186)."""

    fs = frozenset({"start", "stop"})

    def __init__(self, grudge_fn: Callable[[list], dict] | None = None):
        self.grudge_fn = grudge_fn

    def setup(self, test):
        jnet.net_for(test).heal(test)
        return self

    def invoke(self, test, op):
        f = op.get("f")
        if f == "start":
            grudge = op.get("value")
            if grudge is None:
                if self.grudge_fn is None:
                    raise ValueError(f"op {op!r} needs a grudge :value")
                grudge = self.grudge_fn(list(test.get("nodes", [])))
            jnet.net_for(test).drop_all(test, grudge)
            return {**op, "type": "info", "value": ["isolated", grudge]}
        if f == "stop":
            jnet.net_for(test).heal(test)
            return {**op, "type": "info", "value": "network-healed"}
        raise ValueError(f"unknown partitioner op {op!r}")

    def teardown(self, test):
        jnet.net_for(test).heal(test)


def partitioner(grudge_fn=None) -> Nemesis:
    return Partitioner(grudge_fn)


def partition_halves() -> Nemesis:
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves() -> Nemesis:
    def grudge(nodes):
        nodes = random.sample(list(nodes), len(nodes))
        return complete_grudge(bisect(nodes))

    return Partitioner(grudge)


def partition_random_node() -> Nemesis:
    return Partitioner(lambda nodes: complete_grudge(split_one(nodes)))


def partition_majorities_ring() -> Nemesis:
    return Partitioner(majorities_ring)


# ---------------------------------------------------------------------------
# Compose
# ---------------------------------------------------------------------------

class Compose(Nemesis):
    """Routes ops to child nemeses by :f (nemesis.clj:228-311). Takes a
    mapping of f-routers to nemeses: a router is a set of fs (identity
    routing) or a dict rewriting outer fs to inner fs."""

    def __init__(self, children: dict):
        self.children = dict(children)
        fs: set = set()
        for router in self.children:
            fs |= set(router)
        self.fs = frozenset(fs)

    def setup(self, test):
        self.children = {r: n.setup(test) for r, n in self.children.items()}
        return self

    def invoke(self, test, op):
        f = op.get("f")
        for router, nem in self.children.items():
            if f in router:
                inner_f = router[f] if isinstance(router, dict) else f
                res = nem.invoke(test, {**op, "f": inner_f})
                return {**res, "f": f}
        raise ValueError(f"no nemesis handles f={f!r}")

    def teardown(self, test):
        for nem in self.children.values():
            nem.teardown(test)


def compose(children: dict | list) -> Nemesis:
    """compose({frozenset({"start","stop"}): partitioner(...), ...}) or
    compose([nem1, nem2]) using each nemesis's declared fs."""
    if isinstance(children, dict):
        return Compose(children)
    return Compose({frozenset(n.fs): n for n in children})


# ---------------------------------------------------------------------------
# Process-level faults
# ---------------------------------------------------------------------------

class NodeStartStopper(Nemesis):
    """:start runs stop! on targeted nodes; :stop runs start! everywhere
    affected (node-start-stopper, nemesis.clj:335-379)."""

    fs = frozenset({"start", "stop"})

    def __init__(self, targeter: Callable[[list], list],
                 stop_fn: Callable[[dict, str], object],
                 start_fn: Callable[[dict, str], object]):
        self.targeter = targeter
        self.stop_fn = stop_fn
        self.start_fn = start_fn
        self.affected: set = set()

    def invoke(self, test, op):
        f = op.get("f")
        if f == "start":
            targets = list(self.targeter(list(test.get("nodes", []))))
            res = control.on_nodes(test, self.stop_fn, targets)
            self.affected |= set(targets)
            return {**op, "type": "info", "value": [f, dict(res)]}
        if f == "stop":
            nodes = sorted(self.affected)
            res = control.on_nodes(test, self.start_fn, nodes)
            self.affected.clear()
            return {**op, "type": "info", "value": [f, dict(res)]}
        raise ValueError(f"unknown op {op!r}")


def hammer_time(process_name: str, targeter=None) -> Nemesis:
    """SIGSTOP/SIGCONT a process on targeted nodes
    (nemesis.clj:380-394)."""
    targeter = targeter or (lambda nodes: [random.choice(nodes)])

    def stop(test, node):
        cutil.signal(control.current_session().su(), process_name, "STOP")
        return "paused"

    def start(test, node):
        cutil.signal(control.current_session().su(), process_name, "CONT")
        return "resumed"

    return NodeStartStopper(targeter, stop, start)


class TruncateFile(Nemesis):
    """Truncates a file by a few bytes on targeted nodes — corrupting
    logs/segments (nemesis.clj:396-422)."""

    fs = frozenset({"truncate"})

    def __init__(self, path: str, bytes_: int = 100):
        self.path = path
        self.bytes = bytes_

    def invoke(self, test, op):
        targets = op.get("value") or [random.choice(test["nodes"])]

        def trunc(t, node):
            control.current_session().su().exec(
                "truncate", "-c", "-s", f"-{self.bytes}", self.path)
            return "truncated"

        res = control.on_nodes(test, trunc, list(targets))
        return {**op, "type": "info", "value": dict(res)}


def truncate_file(path: str, bytes_: int = 100) -> Nemesis:
    return TruncateFile(path, bytes_)

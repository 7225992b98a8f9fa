"""Composable nemesis packages: nemesis + generators in one bundle.

Counterpart of jepsen.nemesis.combined
(jepsen/src/jepsen/nemesis/combined.clj): a *package* is a dict

    {"nemesis":          the fault injector
     "generator":        op generator for the main phase
     "final_generator":  ops to run at the end (heal/restart everything)
     "perf":             {"name","start","stop"} fs for plot shading}

`nemesis_package(db=..., faults={"partition","kill","pause","clock"},
interval=10)` builds the standard kitchen-sink package
(combined.clj:318-364, default interval combined.clj:26-28).

The port's copy of `jepsen_tpu/nemesis/combined.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import random
from typing import Iterable

from .. import control, db as jdb, generator as gen
from ..control import util as cutil
from ..util import majority
from . import Nemesis, Partitioner, bisect, complete_grudge, compose, \
    majorities_ring, split_one
from .clock import ClockNemesis, clock_gen

DEFAULT_INTERVAL = 10  # seconds between fault ops (combined.clj:26-28)


def db_nodes(test: dict, db, spec) -> list[str]:
    """Interpret a node spec: "one" | "minority" | "majority" | "all" |
    "primaries" | a list of nodes (combined.clj:30-50)."""
    nodes = list(test.get("nodes", []))
    if spec == "one":
        return [random.choice(nodes)]
    if spec == "minority":
        k = max(1, majority(len(nodes)) - 1)
        return random.sample(nodes, k)
    if spec == "majority":
        return random.sample(nodes, majority(len(nodes)))
    if spec == "all":
        return nodes
    if spec == "primaries":
        if isinstance(db, jdb.Primary):
            return list(db.primaries(test)) or [nodes[0]]
        return [nodes[0]]
    return list(spec)


class DBNemesis(Nemesis):
    """Kills/restarts and pauses/resumes DB processes via the DB's
    Process/Pause protocols (combined.clj:59-87)."""

    fs = frozenset({"start-kill", "stop-kill", "start-pause", "stop-pause"})

    def __init__(self, db, fs: frozenset | None = None):
        self.db = db
        if fs is not None:
            self.fs = fs  # restrict routing (e.g. kill-only package)

    def invoke(self, test, op):
        f = op.get("f")
        spec = op.get("value", "one")
        if f == "start-kill":
            targets = db_nodes(test, self.db, spec)
            res = control.on_nodes(
                test, lambda t, n: self.db.kill(t, n) or "killed", targets)
        elif f == "stop-kill":
            res = control.on_nodes(
                test, lambda t, n: self.db.start(t, n) or "started")
        elif f == "start-pause":
            targets = db_nodes(test, self.db, spec)
            res = control.on_nodes(
                test, lambda t, n: self.db.pause(t, n) or "paused", targets)
        elif f == "stop-pause":
            res = control.on_nodes(
                test, lambda t, n: self.db.resume(t, n) or "resumed")
        else:
            raise ValueError(f"unknown db nemesis op {op!r}")
        return {**op, "type": "info", "value": dict(res)}


def _cycle_gen(start_f, start_value_fn, stop_f, interval):
    """start, wait, stop, wait, ... — built from pure combinators
    (a stateful closure here would misfire: generators are asked for ops
    speculatively, so impure state must live in generator structure)."""

    def start(test, ctx):
        return {"type": "info", "f": start_f, "value": start_value_fn(test)}

    stop = {"type": "info", "f": stop_f, "value": None}
    return gen.stagger(interval, gen.flip_flop(
        gen.repeat_gen(start), gen.repeat_gen(stop)))


def partition_package(db=None, interval: float = DEFAULT_INTERVAL,
                      targets: Iterable[str] = ("one", "majority",
                                                "majorities-ring")) -> dict:
    """Partitions package (combined.clj:217-241)."""
    targets = list(targets)

    def grudge(test):
        nodes = list(test.get("nodes", []))
        t = random.choice(targets)
        if t == "one":
            return complete_grudge(split_one(nodes))
        if t == "majority":
            shuffled = random.sample(nodes, len(nodes))
            return complete_grudge(bisect(shuffled))
        if t == "majorities-ring":
            return majorities_ring(nodes)
        if t == "primaries" and db is not None and \
                isinstance(db, jdb.Primary):
            prim = db.primaries(test) or nodes[:1]
            return complete_grudge(split_one(nodes, prim[0]))
        return complete_grudge(bisect(nodes))

    # Route the package's outer fs to the partitioner's start/stop, so
    # the nemesis is usable standalone as well as via compose_packages.
    nemesis = compose({_freeze_router({"start-partition": "start",
                                       "stop-partition": "stop"}):
                       Partitioner(None)})
    return {
        "nemesis": nemesis,
        "generator": _cycle_gen("start-partition", grudge, "stop-partition",
                                interval),
        "final_generator": gen.once({"type": "info", "f": "stop-partition",
                                     "value": None}),
        "perf": {"name": "partition", "start": {"start-partition"},
                 "stop": {"stop-partition"}},
    }


def kill_package(db, interval: float = DEFAULT_INTERVAL,
                 targets=("one", "majority", "all")) -> dict:
    def value(test):
        return random.choice(list(targets))

    return {
        "nemesis": DBNemesis(db, fs=frozenset({"start-kill", "stop-kill"})),
        "generator": _cycle_gen("start-kill", value, "stop-kill", interval),
        "final_generator": gen.once({"type": "info", "f": "stop-kill",
                                     "value": None}),
        "perf": {"name": "kill", "start": {"start-kill"},
                 "stop": {"stop-kill"}},
    }


def pause_package(db, interval: float = DEFAULT_INTERVAL,
                  targets=("one", "majority", "all")) -> dict:
    def value(test):
        return random.choice(list(targets))

    return {
        "nemesis": DBNemesis(db, fs=frozenset({"start-pause", "stop-pause"})),
        "generator": _cycle_gen("start-pause", value, "stop-pause", interval),
        "final_generator": gen.once({"type": "info", "f": "stop-pause",
                                     "value": None}),
        "perf": {"name": "pause", "start": {"start-pause"},
                 "stop": {"stop-pause"}},
    }


def clock_package(db=None, interval: float = DEFAULT_INTERVAL) -> dict:
    """Clock faults package (combined.clj:243-292)."""
    return {
        "nemesis": ClockNemesis(),
        "generator": gen.stagger(interval, clock_gen()),
        "final_generator": gen.once({"type": "info", "f": "reset",
                                     "value": None}),
        "perf": {"name": "clock", "start": {"bump", "strobe"},
                 "stop": {"reset"}},
    }


def compose_packages(packages: list[dict]) -> dict:
    """Merge packages: nemeses composed by f-routing, generators merged
    with `any`, final generators run in sequence (combined.clj:294-316)."""
    routes = {}
    claimed: dict = {}
    for p in packages:
        nem = p["nemesis"]
        fs = frozenset(nem.fs)
        for f in fs:
            if f in claimed:
                raise ValueError(
                    f"nemesis op {f!r} routed to two packages "
                    f"({claimed[f]!r} and {nem!r}); packages must have "
                    f"disjoint :f sets")
            claimed[f] = nem
        routes[fs] = nem
    return {
        "nemesis": compose(routes),
        "generator": gen.any_gen(*[p["generator"] for p in packages]),
        "final_generator": [p["final_generator"] for p in packages
                            if p.get("final_generator") is not None],
        "perf": [p["perf"] for p in packages],
    }


class _FrozenDictRouter(dict):
    def __hash__(self):
        return hash(frozenset(self.items()))


def _freeze_router(router):
    if isinstance(router, dict):
        return _FrozenDictRouter(router)
    return frozenset(router)


def nemesis_package(db=None, interval: float = DEFAULT_INTERVAL,
                    faults: Iterable[str] = ("partition", "kill", "pause",
                                             "clock"),
                    partition_targets=("one", "majority",
                                       "majorities-ring")) -> dict:
    """The standard fault bundle (combined.clj:318-364). Only faults the
    DB supports are included."""
    faults = set(faults)
    packages = []
    if "partition" in faults:
        packages.append(partition_package(db, interval, partition_targets))
    if "kill" in faults and isinstance(db, jdb.Process):
        packages.append(kill_package(db, interval))
    if "pause" in faults and isinstance(db, jdb.Pause):
        packages.append(pause_package(db, interval))
    if "clock" in faults:
        packages.append(clock_package(db, interval))
    if not packages:
        from . import noop
        return {"nemesis": noop(), "generator": None,
                "final_generator": None, "perf": []}
    return compose_packages(packages)

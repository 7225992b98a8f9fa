"""Per-database test suites.

Counterpart of the reference's per-DB subprojects (SURVEY.md §2.6): each
suite module exposes

    workloads        {name: fn(opts) -> {"generator", "checker", ...}}
    <db>_test(opts)  a full test map for one workload
    main()           CLI entry (test / analyze / serve subcommands)

following the etcd template (etcd/src/jepsen/etcd.clj:154-191). Suites
with workload matrices (tidb/core.clj:32-100, yugabyte/core.clj:74-110,
cockroachdb, dgraph) build their maps from the shared workload library;
`all_tests` expands the sweep the way the reference's test-all does.

The port's copy of `jepsen_tpu/suites/__init__.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

from .. import generator as gen
from ..workloads import (adya, append, bank, causal_reverse, long_fork,
                         monotonic, register, set_workload, wr)

#: Every per-DB suite module (the reference's 27 sibling subprojects,
#: SURVEY.md §2.6; mongodb is the shared core behind the -rocks and
#: -smartos variants).
SUITES = (
    "aerospike", "charybdefs", "chronos", "cockroach", "consul",
    "crate", "dgraph", "disque", "elasticsearch", "etcd", "faunadb",
    "galera", "hazelcast", "ignite", "logcabin", "mongodb",
    "mongodb_rocks", "mongodb_smartos", "mysql_cluster", "percona",
    "postgres_rds", "rabbitmq", "raftis", "rethinkdb", "robustirc",
    "tidb", "yugabyte", "zookeeper",
)


def load_suite(name: str):
    """Import a suite module by name (lazy: suites pull in their
    drivers only when used)."""
    if name not in SUITES:
        raise ValueError(f"unknown suite {name!r}; have {SUITES}")
    return importlib.import_module(f".{name}", __package__)


def base_opts(**kw) -> dict:
    """Default CLI-ish options (cli.clj:18,78-99)."""
    opts = {
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "concurrency": 5,
        "time-limit": 60,
        "ssh": {},
    }
    opts.update(kw)
    return opts


def standard_workloads(opts: dict | None = None) -> dict[str, Callable]:
    """The workload registry shared by the matrix suites. Each entry
    returns a {"generator", "checker"} package. The checkers that reach
    a kernel (append, wr, register) run on `opts["device"]` (default
    cuda)."""
    opts = opts or {}
    nodes = opts.get("nodes") or ["n1", "n2", "n3", "n4", "n5"]
    device = opts.get("device")
    return {
        "register": lambda: _pkg(register.test(device=device)),
        "bank": lambda: _pkg(bank.test()),
        "set": lambda: _pkg(set_workload.test(n=opts.get("set-size", 100))),
        "append": lambda: _pkg(append.test(device=device)),
        "wr": lambda: _pkg(wr.test(device=device)),
        "long-fork": lambda: long_fork.workload(
            opts.get("long-fork-group", 2)),
        "monotonic": lambda: monotonic.workload(),
        "sequential": lambda: causal_reverse.workload(nodes),
        "g2": lambda: adya.workload(),
    }


def _pkg(test_map: dict) -> dict:
    return {"generator": test_map.get("generator"),
            "checker": test_map.get("checker")}


def resolve_workload(args, tmap: dict, default: str) -> str:
    """--workload wins when given explicitly; a stored run's workload
    wins over the suite default so `analyze` re-checks with the right
    model (cli.clj:381-411)."""
    return (getattr(args, "workload", None) or tmap.get("workload")
            or default)


def nemesis_cycle(interval: float = 10) -> Any:
    """The standard start/stop nemesis schedule
    (etcd.clj:174-178, combined.clj:26-28). gen.cycle — NOT repeat_gen,
    which re-yields the first sleep forever and never starts a fault."""
    return gen.cycle([gen.sleep(interval),
                      {"type": "info", "f": "start"},
                      gen.sleep(interval),
                      {"type": "info", "f": "stop"}])


def suite_test(name: str, workload_name: str, opts: dict,
               workloads: dict[str, Callable],
               db=None, client=None, nemesis=None,
               os_setup=None) -> dict:
    """Assemble a full test map from a workload registry entry, the way
    each suite's <db>-test does (etcd.clj:154-180)."""
    if workload_name not in workloads:
        raise ValueError(
            f"unknown workload {workload_name!r}; "
            f"have {sorted(workloads)}")
    wl = workloads[workload_name]()
    g = wl["generator"]
    interval = opts.get("nemesis-interval", 10)
    nemesis_gen = nemesis_cycle(interval)
    # Combined fault bundle for ANY suite (combined.clj:318-364): opts
    # {"faults": ["partition", "kill", "pause", "clock"]} swaps the
    # plain start/stop partition schedule for the composed package's
    # nemesis + generator (faults the DB can't support are dropped).
    heal_gen = gen.once({"type": "info", "f": "stop"})
    if opts.get("faults"):
        # An explicit fault request beats the suite's default nemesis —
        # every suite bakes one in, so "explicit argument wins" would
        # make the flag a no-op everywhere.
        from ..nemesis import combined as ncombined
        pkg = ncombined.nemesis_package(
            db, interval, faults=opts["faults"])
        nemesis = pkg["nemesis"]
        if pkg.get("generator") is not None:
            nemesis_gen = pkg["generator"]
        if pkg.get("final_generator") is not None:
            heal_gen = pkg["final_generator"]
    main_gen = gen.time_limit(
        opts.get("time-limit", 60),
        gen.clients(g, nemesis_gen))
    if wl.get("final_generator") is not None:
        # post-time-limit phase (queue drains, final reads): heal the
        # nemesis first so a live partition can't wedge an until-ok
        # final phase (the reference's std-gen shape)
        main_gen = gen.phases(
            main_gen,
            gen.nemesis(heal_gen),
            wl["final_generator"])
    test = {
        "name": f"{name} {workload_name}",
        "nodes": opts.get("nodes"),
        "concurrency": opts.get("concurrency", 5),
        "ssh": opts.get("ssh", {}),
        "generator": main_gen,
        "checker": wl["checker"],
        "workload": workload_name,
    }
    # Omit unset roles so core.run's defaults (noop db/os/...) apply.
    # A workload entry may carry its own default client (e.g. per-mode
    # wire clients); an explicit `client` argument wins.
    client = client if client is not None else wl.get("client")
    for key, val in (("db", db), ("client", client),
                     ("nemesis", nemesis), ("os", os_setup)):
        if val is not None:
            test[key] = val
    test.update(opts.get("extra", {}))
    # Carry every other opt through (store, start-time, ssh details...)
    # so `analyze` on a stored run writes back into the SAME run dir.
    for k, v in opts.items():
        if k != "extra":
            test.setdefault(k, v)
    if "start-time" in opts and opts.get("name"):
        test["name"] = opts["name"]
    return test


def all_tests(name: str, opts: dict, workloads: dict[str, Callable],
              **kw) -> list[dict]:
    """One test map per workload — the suite sweep (tidb/core.clj:32-100,
    cli.clj test-all)."""
    return [suite_test(name, w, opts, workloads, **kw)
            for w in sorted(workloads)]

"""The test runner: the port's copy of `jepsen_tpu/core.py`.

Counterpart of jepsen.core (jepsen/src/jepsen/core.clj): `run(test)`
provisions the OS and DB over the control plane, sets up clients and the
nemesis, evaluates the generator through the interpreter while capturing
a history, persists it (`Store.save_1`), analyzes it with the test's
checker, and tears the world down again (run! core.clj:530-637;
analyze! 496-513). `analyze(test)` alone is what `analyze` and the
stored-checker path of `analyze-store` call.

A test is a plain dict — the universal config object (core.clj:531-554):

    {"name":        str
     "nodes":       ["n1", ...]
     "concurrency": int                    # client worker count
     "ssh":         {"username", "port", "dummy", ...}
     "os":          OS                     # os_setup.OS
     "db":          DB                     # db.DB
     "client":      Client                 # client.Client
     "nemesis":     Nemesis                # nemesis.Nemesis
     "generator":   generator              # generator DSL value
     "checker":     Checker                # checker.Checker
     "store":       Store (optional)
     "leave_db_running": bool}

A checker built without a device is the device path (cuda): without a
card it raises DeviceUnavailable out of `run`, as a kernel build or
launch failure does, and no verdict is written.
"""

from __future__ import annotations

import datetime
import logging
import os as _os

from . import checker as jchecker
from . import client as jclient
from . import control, db as jdb, history as jhistory, os_setup, trace
from .generator import interpreter
from .store import Store
from .util import real_pmap, relative_time

log = logging.getLogger(__name__)

DEFAULTS = {
    "name": "noname",
    "nodes": ["n1", "n2", "n3", "n4", "n5"],
    "concurrency": 5,
    "ssh": {},
    "leave_db_running": False,
}


def prepare_test(test: dict) -> dict:
    """Fill in defaults; resolve concurrency "2n" syntax
    (cli.clj:138-153)."""
    t = {**DEFAULTS, **test}
    conc = t.get("concurrency")
    if isinstance(conc, str):
        if conc.endswith("n"):
            mult = conc[:-1] or "1"
            t["concurrency"] = int(mult) * len(t["nodes"])
        else:
            t["concurrency"] = int(conc)
    t.setdefault("os", os_setup.noop())
    t.setdefault("db", jdb.noop())
    t.setdefault("client", jclient.noop())
    t.setdefault("checker", jchecker.unbridled_optimism())
    if "start-time" not in t:
        t["start-time"] = datetime.datetime.now().strftime(
            "%Y%m%dT%H%M%S.%f")[:-3]
    return t


def setup_clients(test: dict) -> list:
    """Open one client per node and run setup (core.clj:457-476)."""
    base = test.get("client")

    def setup1(node):
        c = base.open(test, node)
        try:
            c.setup(test)
        finally:
            c.close(test)

    real_pmap(setup1, test.get("nodes", []))
    return []


def teardown_clients(test: dict) -> None:
    base = test.get("client")

    def teardown1(node):
        c = base.open(test, node)
        try:
            c.teardown(test)
        finally:
            c.close(test)

    try:
        real_pmap(teardown1, test.get("nodes", []))
    except Exception as e:
        log.warning("client teardown failed: %s", e)


def snarf_logs(test: dict) -> None:
    """Download DB log files from each node into the store
    (core.clj:103-137)."""
    db = test.get("db")
    if not isinstance(db, jdb.LogFiles):
        return
    store: Store = test["store"]

    def snarf1(t, node):
        sess = control.current_session()
        for f in db.log_files(t, node):
            dest = store.path(t, node, _os.path.basename(f))
            try:
                sess.download(f, str(dest))
            except Exception as e:
                log.warning("couldn't snarf %s from %s: %s", f, node, e)

    try:
        control.on_nodes(test, snarf1)
    except Exception as e:
        log.warning("log snarfing failed: %s", e)


def analyze(test: dict) -> dict:
    """Index the history, run the checker (inside an "analyze" trace
    span), settle any race it started, persist results."""
    log.info("Analyzing...")
    test["history"] = jhistory.index(test.get("history", []))
    with trace.span("analyze", ops=len(test["history"])):
        results = jchecker.check_safe(
            test.get("checker") or jchecker.unbridled_optimism(),
            test, test["history"], {})
    # a race's losing device side ends before the verdict is written,
    # so a failure it meets is raised here, not dropped
    jchecker.Linearizable.settle_races()
    test["results"] = results
    store: Store = test.get("store") or Store()
    test["store"] = store
    store.save_2(test)
    log.info("Analysis complete: valid? = %r", results.get("valid?"))
    return test


def run(test: dict) -> dict:
    """Run a complete test; returns the test with :history and :results
    (run! core.clj:530-637)."""
    test = prepare_test(test)
    store: Store = test.get("store") or Store()
    test["store"] = store
    log.info("Running test %s", test["name"])
    # A fresh per-run tracer: trace.json/metrics.json written by
    # save_2 cover exactly this run. JEPSEN_TPU_JAX_PROFILE=1
    # (--jax-profile) additionally wraps the run in a torch.profiler
    # capture landing in the run dir.
    trace.fresh_run(test.get("name"))
    profile_cm = trace.profile_session(
        store.test_dir(test) / "torch-profile")

    os_ = test["os"]
    db = test["db"]
    nemesis = test.get("nemesis")
    try:
        # L1: provision OS, then cycle the DB.
        control.on_nodes(test, os_.setup)
        try:
            with trace.span("db.cycle"):
                jdb.cycle(db, test)
            try:
                if nemesis is not None:
                    test["nemesis"] = nemesis = nemesis.setup(test)
                setup_clients(test)

                with profile_cm:
                    with relative_time(), trace.span("generator.run"):
                        history = interpreter.run(test)
                    test["history"] = jhistory.index(history)
                    store.save_1(test)

                    analyze(test)
            finally:
                try:
                    teardown_clients(test)
                finally:
                    if nemesis is not None:
                        try:
                            nemesis.teardown(test)
                        except Exception as e:
                            log.warning("nemesis teardown failed: %s", e)
        finally:
            snarf_logs(test)
            if not test.get("leave_db_running"):
                try:
                    jdb.teardown_all(db, test)
                except Exception as e:
                    log.warning("db teardown failed: %s", e)
    finally:
        try:
            control.on_nodes(test, os_.teardown)
        except Exception as e:
            log.warning("os teardown failed: %s", e)
    return test

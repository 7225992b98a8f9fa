"""Analysis of one stored run: the part of `jepsen_tpu/core.py` the
stored-checker path of `analyze-store` calls.

`analyze(test)` indexes the history, runs the test's own checker
(`unbridled_optimism` when it has none: a checker never serializes into
a stored test map, see `store.NONSERIALIZABLE_KEYS`) through
`check_safe`, and persists the results with `Store.save_2`.
"""

from __future__ import annotations

import logging

from . import checker as jchecker
from . import history as jhistory
from .store import Store

log = logging.getLogger(__name__)


def analyze(test: dict) -> dict:
    """Index the history, run the checker (inside an "analyze" trace
    span), settle any race it started, persist results."""
    from . import trace
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

"""Bank workload: total balance must be conserved.

Counterpart of jepsen.tests.bank (jepsen/src/jepsen/tests/bank.clj):
clients transfer money between accounts and read all balances; under
snapshot isolation the total must stay constant and (by default) no
balance may go negative (bank.clj:93-130).

Ops:
    {"f": "read"}                                  -> {account: balance}
    {"f": "transfer", "value": {"from","to","amount"}}

The port's copy of `jepsen_tpu/workloads/bank.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import random

from .. import generator as gen
from ..checker import Checker


DEFAULT_ACCOUNTS = list(range(8))
DEFAULT_TOTAL = 100
DEFAULT_MAX_TRANSFER = 5


class BankChecker(Checker):
    """Every read must total `total`; negative balances are errors unless
    allowed (bank.clj:93-130)."""

    def __init__(self, total: int = DEFAULT_TOTAL,
                 negative_balances: bool = False):
        self.total = total
        self.negative_balances = negative_balances

    def check(self, test, history, opts):
        total = test.get("total-amount", self.total)
        bad_reads = []
        read_count = 0
        for op in history:
            if op.get("type") != "ok" or op.get("f") != "read":
                continue
            read_count += 1
            balances = op.get("value") or {}
            s = sum(balances.values())
            errs = []
            if s != total:
                errs.append(f"total {s} != {total}")
            if not self.negative_balances:
                neg = {a: b for a, b in balances.items() if b < 0}
                if neg:
                    errs.append(f"negative balances {neg}")
            if errs:
                bad_reads.append({"op": op, "errors": errs})
        if read_count == 0:
            return {"valid?": "unknown", "error": "no reads"}
        return {"valid?": not bad_reads,
                "read-count": read_count,
                "bad-reads": bad_reads[:10],
                "bad-read-count": len(bad_reads)}


class BankPlot(Checker):
    """Renders bank.png: every account's balance over time from the ok
    reads, with nemesis shading — the reference's balance plot
    (bank.clj:160-186, drawn through perf/plot!). Always valid; the
    plot is the artifact."""

    def __init__(self, nemeses=None):
        self.nemeses = nemeses

    def check(self, test, history, opts):
        from ..checker import perf

        path = perf.store_path(test, opts, "bank.png")
        if path is None:
            return {"valid?": True}
        series: dict = {}
        times: dict = {}
        for op in history:
            if op.get("type") != "ok" or op.get("f") != "read":
                continue
            t = perf.nanos_to_secs(op.get("time", 0))
            for acct, bal in (op.get("value") or {}).items():
                series.setdefault(acct, []).append(bal)
                times.setdefault(acct, []).append(t)
        if not series:
            return {"valid?": True, "plot": None}
        fig, ax = perf.fig_ax(test.get("name", "bank"), "balance",
                              logy=False)
        for acct in sorted(series, key=repr):
            ax.plot(times[acct], series[acct], lw=1,
                    label=f"account {acct}")
        nemeses = self.nemeses or (test.get("plot") or {}).get("nemeses")
        perf.draw_nemeses(ax, history, nemeses, perf.t_max(history))
        ax.grid(True, alpha=0.3)
        perf.finish(fig, ax, path)
        return {"valid?": True, "plot": str(path)}


def plot_checker(nemeses=None) -> Checker:
    return BankPlot(nemeses)


def checker(**kw) -> Checker:
    return BankChecker(**kw)


def generator(accounts=None, max_transfer=DEFAULT_MAX_TRANSFER):
    accounts = accounts or DEFAULT_ACCOUNTS

    def read(test=None, ctx=None):
        return {"type": "invoke", "f": "read", "value": None}

    def transfer(test=None, ctx=None):
        a, b = random.sample(accounts, 2)
        return {"type": "invoke", "f": "transfer",
                "value": {"from": a, "to": b,
                          "amount": random.randint(1, max_transfer)}}

    return gen.clients(gen.mix([read, transfer]))


def test(accounts=None, total=DEFAULT_TOTAL,
         max_transfer=DEFAULT_MAX_TRANSFER, plot: bool = True,
         nemeses=None, **kw) -> dict:
    """Partial test map; the checker composes the balance invariant
    with the balance-over-time plot (bank.clj:188-201)."""
    from ..checker import compose

    accounts = accounts or DEFAULT_ACCOUNTS
    balance = checker(total=total, **kw)
    return {"generator": generator(accounts, max_transfer),
            "checker": compose({"bank": balance,
                                "plot": plot_checker(nemeses)}) if plot
            else balance,
            "accounts": accounts,
            "total-amount": total,
            "max-transfer": max_transfer}

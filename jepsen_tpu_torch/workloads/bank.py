"""Bank workload: total balance must be conserved.

Counterpart of jepsen.tests.bank (jepsen/src/jepsen/tests/bank.clj):
clients transfer money between accounts and read all balances; under
snapshot isolation the total must stay constant and (by default) no
balance may go negative (bank.clj:93-130).

Ops:
    {"f": "read"}                                  -> {account: balance}
    {"f": "transfer", "value": {"from","to","amount"}}

The port's copy of `jepsen_tpu/workloads/bank.py`; it imports the
standard library and the port's own modules only. The balance plot is
not ported (see `test`).
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
         max_transfer=DEFAULT_MAX_TRANSFER, plot: bool = False,
         nemeses=None, **kw) -> dict:
    """Partial test map; the checker is the balance invariant
    (bank.clj:188-201). The reference composes it with the
    balance-over-time plot (bank.png, drawn with matplotlib, by
    default), which the port does not render: its default is
    `plot=False`, and `plot=True` raises ValueError. `nemeses` is the
    plot's and is accepted for the reference's signature."""
    if plot:
        raise ValueError("the bank plot (bank.png) is not ported; "
                         "pass plot=False")
    accounts = accounts or DEFAULT_ACCOUNTS
    return {"generator": generator(accounts, max_transfer),
            "checker": checker(total=total, **kw),
            "accounts": accounts,
            "total-amount": total,
            "max-transfer": max_transfer}

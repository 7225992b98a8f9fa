"""Long-fork workload: a parallel-snapshot-isolation anomaly where
concurrent writes are observed in conflicting orders by different reads.

Counterpart of jepsen.tests.long-fork
(jepsen/src/jepsen/tests/long_fork.clj). Writes are single-key inserts
``[["w", k, 1]]``, each key written at most once; reads scan a whole
*group* of n consecutive keys. Reads over the same group must form a
total order under "dominates" comparison (nil -> value transitions only);
two mutually incomparable reads are a long fork (read-compare
long_fork.clj:210-246; find-forks 268-276).

The port's copy of `jepsen_tpu/workloads/long_fork.py`; it imports the
standard library, numpy and the port's own modules only.
"""

from __future__ import annotations

import random
from typing import Any, Sequence

from .. import generator as gen
from ..checker import Checker


def group_for(n: int, k: int) -> range:
    """The n keys of k's group: [k - k%n, k - k%n + n) (long_fork.clj:100-106)."""
    lo = k - (k % n)
    return range(lo, lo + n)


def read_txn_for(n: int, k: int, rng: random.Random | None = None) -> list:
    """A txn reading k's whole group in shuffled order (long_fork.clj:108-114)."""
    ks = list(group_for(n, k))
    (rng or random).shuffle(ks)
    return [["r", kk, None] for kk in ks]


class LongForkGen(gen.Generator):
    """Single inserts followed by group reads from the same worker, mixed
    with reads of other in-flight groups (Generator long_fork.clj:116-151).

    State: next_key counter + {worker: last-written-key} + a step seed.
    Randomness is derived afresh from the seed each op() so a re-invoked
    op() on the same state yields the same op (pure-generator contract);
    every successor state carries seed+1."""

    def __init__(self, n: int, next_key: int = 0,
                 workers: dict | None = None, seed: int = 0):
        self.n = n
        self.next_key = next_key
        self.workers = workers or {}
        self.seed = seed

    def op(self, test, ctx):
        worker = next((t for t in ctx.free_threads if t != gen.NEMESIS), None)
        if worker is None:
            return gen.PENDING, self
        rng = random.Random(f"long-fork:{self.seed}:{worker}")
        process = ctx.thread_to_process(worker)
        k = self.workers.get(worker)
        if k is not None:
            # We wrote a key: read its group and clear our slot.
            o = gen.fill_in_op(
                {"process": process, "f": "read",
                 "value": read_txn_for(self.n, k, rng)}, ctx)
            return o, LongForkGen(self.n, self.next_key,
                                  {**self.workers, worker: None},
                                  seed=self.seed + 1)
        active = [v for v in self.workers.values() if v is not None]
        if active and rng.random() < 0.5:
            k = rng.choice(active)
            o = gen.fill_in_op(
                {"process": process, "f": "read",
                 "value": read_txn_for(self.n, k, rng)}, ctx)
            return o, LongForkGen(self.n, self.next_key, self.workers,
                                  seed=self.seed + 1)
        o = gen.fill_in_op(
            {"process": process, "f": "write",
             "value": [["w", self.next_key, 1]]}, ctx)
        return o, LongForkGen(self.n, self.next_key + 1,
                              {**self.workers, worker: self.next_key},
                              seed=self.seed + 1)


def generator(n: int = 2) -> gen.Generator:
    return LongForkGen(n)


class IllegalHistory(Exception):
    def __init__(self, info: dict):
        self.info = info
        super().__init__(str(info))


def read_op_value_map(op: dict) -> dict:
    """read txn -> {key: value} (long_fork.clj:248-257)."""
    return {m[1]: m[2] for m in (op.get("value") or [])}


def read_compare(a: dict, b: dict) -> int | None:
    """-1 if a dominates, 0 equal, 1 if b dominates, None incomparable.
    Values change only nil -> written-once value (long_fork.clj:210-246)."""
    if len(a) != len(b):
        raise IllegalHistory({"type": "illegal-history", "reads": [a, b],
                              "msg": "reads query different keys"})
    res = 0
    for k, va in a.items():
        if k not in b:
            raise IllegalHistory({"type": "illegal-history", "reads": [a, b],
                                  "key": k,
                                  "msg": "reads query different keys"})
        vb = b[k]
        if va == vb:
            continue
        if vb is None:           # a saw a value b didn't: a dominates here
            if res > 0:
                return None
            res = -1
        elif va is None:         # b dominates here
            if res < 0:
                return None
            res = 1
        else:
            raise IllegalHistory(
                {"type": "illegal-history", "key": k, "reads": [a, b],
                 "msg": "distinct non-nil values for one key; "
                        "keys are written once"})
    return res


def is_read_txn(txn) -> bool:
    return all(m[0] == "r" for m in (txn or []))


def is_write_txn(txn) -> bool:
    return bool(txn) and len(txn) == 1 and txn[0][0] == "w"


def find_forks(ops: Sequence[dict]) -> list:
    """All mutually incomparable read pairs in one group
    (long_fork.clj:259-276)."""
    forks = []
    for i in range(len(ops)):
        ma = read_op_value_map(ops[i])
        for j in range(i + 1, len(ops)):
            if read_compare(ma, read_op_value_map(ops[j])) is None:
                forks.append([ops[i], ops[j]])
    return forks


# Past this many reads in one group the pairwise python comparator is
# replaced by the vectorized matmul formulation below.
VECTORIZE_THRESHOLD = 64


def find_forks_vectorized(ops: Sequence[dict]) -> list:
    """find_forks as one boolean matmul (SURVEY.md §5.7's blockwise
    long-fork search for 100k-op histories, BASELINE config #5).

    Keys are written once with value 1, so a read of a group is a 0/1
    vector V[i] over the group's keys (1 = observed). Read i strictly
    dominates j on some key iff (V @ (1-V)^T)[i, j] > 0; a long fork is
    a pair dominating each other: G & G^T. Value/shape validation stays
    host-side (read_op_value_map raises on distinct non-nil values the
    same way the pairwise route does)."""
    import numpy as np

    if len(ops) < 2:
        return []
    keys = sorted(read_op_value_map(ops[0]),
                  key=lambda k: (str(type(k)), str(k)))
    maps = [read_op_value_map(o) for o in ops]
    for m in maps[1:]:
        if set(m) != set(keys):
            raise IllegalHistory(
                {"type": "illegal-history", "reads": [maps[0], m],
                 "msg": "reads query different keys"})
    # exact parity with read_compare's error rule: a key may show ONE
    # non-nil value across all reads (keys are written once); two
    # distinct non-nil values is an illegal history
    for k in keys:
        distinct = {m[k] for m in maps if m[k] is not None}
        if len(distinct) > 1:
            raise IllegalHistory(
                {"type": "illegal-history", "key": k,
                 "reads": [m for m in maps if m[k] is not None][:2],
                 "msg": "distinct non-nil values for one key; "
                        "keys are written once"})
    V = np.asarray([[0 if m[k] is None else 1 for k in keys]
                    for m in maps], dtype=np.float32)
    W = 1.0 - V
    R = len(maps)
    block = 4096                       # memory stays O(block * R)
    forks = []
    for lo in range(0, R, block):
        hi = min(lo + block, R)
        A = (V[lo:hi] @ W.T) > 0       # i saw a key j missed
        B = (W[lo:hi] @ V.T) > 0       # j saw a key i missed
        F = A & B                      # mutual: a long fork
        for il, j in zip(*np.nonzero(F)):
            i = lo + int(il)
            if i < j:                  # each unordered pair once
                forks.append([ops[i], ops[int(j)]])
    return forks


def groups(n: int, read_ops: Sequence[dict]) -> list[list[dict]]:
    """Partition reads by their key set; each must cover exactly n keys
    (long_fork.clj:288-314)."""
    by_keys: dict[frozenset, list] = {}
    for op in read_ops:
        ks = frozenset(m[1] for m in (op.get("value") or []))
        by_keys.setdefault(ks, []).append(op)
    for ks, ops in by_keys.items():
        if len(ks) != n:
            raise IllegalHistory(
                {"type": "illegal-history", "op": ops[0],
                 "msg": f"every read should observe exactly {n} keys, "
                        f"got {len(ks)}"})
    return list(by_keys.values())


class LongForkChecker(Checker):
    """Verifies single-write keys, then searches every read group for
    incomparable pairs (checker long_fork.clj:363-378)."""

    def __init__(self, n: int):
        self.n = n

    def check(self, test, history, opts):
        reads = [o for o in history
                 if o.get("type") == "ok" and is_read_txn(o.get("value"))]
        early = [v for v in (o.get("value") for o in reads)
                 if not any(m[2] is not None for m in v)]
        late = [v for v in (o.get("value") for o in reads)
                if all(m[2] is not None for m in v)]
        base = {"reads-count": len(reads),
                "early-read-count": len(early),
                "late-read-count": len(late)}
        # multiple writes to one key -> unknown (long_fork.clj:327-342)
        seen: set = set()
        for o in history:
            if o.get("type") == "invoke" and is_write_txn(o.get("value")):
                k = o["value"][0][1]
                if k in seen:
                    return {**base, "valid?": "unknown",
                            "error": ["multiple-writes", k]}
                seen.add(k)
        try:
            forks = [f for g in groups(self.n, reads)
                     for f in (find_forks_vectorized(g)
                               if len(g) > VECTORIZE_THRESHOLD
                               else find_forks(g))]
        except IllegalHistory as e:
            return {**base, "valid?": "unknown", "error": e.info}
        if forks:
            return {**base, "valid?": False, "forks": forks}
        return {**base, "valid?": True}


def checker(n: int = 2) -> Checker:
    return LongForkChecker(n)


def workload(n: int = 2) -> dict:
    """{"checker", "generator"} package (long_fork.clj:380-385)."""
    return {"checker": checker(n), "generator": generator(n)}
